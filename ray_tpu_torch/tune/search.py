"""Search spaces + the basic variant generator.

Reference analog: tune/search/{sample.py,basic_variant.py} — grid_search
expands cartesian products; stochastic domains (uniform/loguniform/choice/
randint) sample per trial.

A copy of ``ray_tpu/tune/search.py``.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        if low <= 0 or high <= 0:
            raise ValueError("loguniform bounds must be positive")
        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self._lo, self._hi))


class Randint(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> Randint:
    return Randint(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


class BasicVariantGenerator:
    """Expand grid axes fully; sample stochastic domains num_samples
    times per grid point (reference tune/search/basic_variant.py)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = param_space or {}
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, GridSearch)]
        grid_vals = [self.param_space[k].values for k in grid_keys]
        out: List[Dict[str, Any]] = []
        for combo in itertools.product(*grid_vals) if grid_keys else [()]:
            for _ in range(self.num_samples):
                cfg: Dict[str, Any] = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    else:
                        cfg[k] = v
                out.append(cfg)
        return out


# ---------------------------------------------------------------------------
# Model-based search
# ---------------------------------------------------------------------------

class Searcher:
    """Sequential model-based searcher interface (reference analog:
    tune/search/searcher.py Searcher — suggest/on_trial_complete).

    Unlike BasicVariantGenerator (which expands the whole trial list up
    front), a Searcher proposes configs one at a time, conditioning each
    suggestion on every completed trial's score."""

    def setup(self, param_space: Dict[str, Any], metric: str,
              mode: str, seed: Optional[int] = None) -> None:
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]], *,
                          error: bool = False,
                          config: Optional[Dict[str, Any]] = None) -> None:
        """``error=True`` marks a crashed trial (its last report must not
        count as a completed observation); ``config`` lets the runner
        supply the trial's config when ``trial_id`` was never suggested
        by this searcher (restored experiments)."""
        raise NotImplementedError

    def observe(self, config: Dict[str, Any],
                result: Dict[str, Any], *, error: bool = False) -> None:
        """Seed the model with an already-completed (config, result)
        pair — used when resuming an experiment."""


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator, implemented natively (reference
    ships an adapter to the external hyperopt package,
    tune/search/hyperopt/hyperopt_search.py:40; this is a from-scratch
    TPE over this module's Domain types — no external dependency).

    Per suggestion: split completed trials into the top ``gamma``
    fraction ("good") and the rest ("bad"); per hyperparameter, draw
    ``n_candidates`` samples from a Parzen (kernel-density) estimate of
    the good set and keep the one maximizing the density ratio
    l(x)/g(x).  Dimensions are treated independently, like hyperopt's
    factorized TPE.  The first ``n_initial`` suggestions are random
    (startup jitter for the density estimates)."""

    def __init__(self, n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._live: Dict[str, Dict[str, Any]] = {}   # trial_id -> config
        self._obs: List[tuple] = []                  # (config, score)

    def setup(self, param_space, metric, mode, seed=None):
        super().setup(param_space, metric, mode, seed)
        # reset: a searcher instance reused across fit() calls must not
        # carry the previous experiment's observations (possibly under a
        # different mode/space) into this one
        self._live = {}
        self._obs = []
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    f"TPESearcher does not accept grid_search axes "
                    f"(key {k!r}); use Domain types or "
                    f"BasicVariantGenerator")

    # -- observation bookkeeping -----------------------------------------

    def on_trial_complete(self, trial_id, result, *, error=False,
                          config=None):
        cfg = self._live.pop(trial_id, None)
        if cfg is None:
            cfg = config  # restored trial: id predates this searcher
        if cfg is None:
            return
        self.observe(cfg, result, error=error)

    def observe(self, config, result, *, error=False):
        import math

        if error:
            # a crashed trial is evidence AGAINST its config — rank it
            # worse than every real observation so TPE's split puts it
            # in the "bad" density, instead of trusting the (possibly
            # deceptively good) last report before the crash
            self._obs.append((config, math.inf))
            return
        if not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score  # normalize: lower is always better
        self._obs.append((config, score))

    # -- suggestion -------------------------------------------------------

    def suggest(self, trial_id):
        if len(self._obs) < self.n_initial:
            cfg = self._sample_random()
        else:
            cfg = self._sample_tpe()
        self._live[trial_id] = cfg
        return dict(cfg)

    def _sample_random(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.param_space.items():
            out[k] = v.sample(self.rng) if isinstance(v, Domain) else v
        return out

    def _split(self):
        import math

        ranked = sorted(self._obs, key=lambda o: o[1])
        n_good = max(1, math.ceil(self.gamma * len(ranked)))
        return ranked[:n_good], ranked[n_good:]

    def _sample_tpe(self) -> Dict[str, Any]:
        good, bad = self._split()
        out = {}
        for k, dom in self.param_space.items():
            if not isinstance(dom, Domain):
                out[k] = dom
                continue
            gx = [c[k] for c, _ in good if k in c]
            bx = [c[k] for c, _ in bad if k in c]
            if isinstance(dom, Choice):
                out[k] = self._choice_tpe(dom, gx, bx)
            elif isinstance(dom, (Uniform, LogUniform, Randint)):
                out[k] = self._numeric_tpe(dom, gx, bx)
            else:
                out[k] = dom.sample(self.rng)
        return out

    def _choice_tpe(self, dom: Choice, gx, bx):
        """Categorical: weight ∝ smoothed good-count / smoothed bad-count."""
        cats = dom.categories
        weights = []
        for c in cats:
            lg = (sum(1 for x in gx if x == c) + 1) / (len(gx) + len(cats))
            bg = (sum(1 for x in bx if x == c) + 1) / (len(bx) + len(cats))
            weights.append(lg / bg)
        total = sum(weights)
        r = self.rng.uniform(0, total)
        acc = 0.0
        for c, w in zip(cats, weights):
            acc += w
            if r <= acc:
                return c
        return cats[-1]

    def _numeric_tpe(self, dom, gx, bx):
        """Parzen mixture over the good points in the domain's natural
        space (log space for LogUniform); candidates scored by l/g."""
        import math

        if isinstance(dom, LogUniform):
            lo, hi = dom._lo, dom._hi
            fwd, inv = math.log, math.exp
        elif isinstance(dom, Randint):
            lo, hi = float(dom.low), float(dom.high - 1)
            fwd, inv = float, lambda x: int(round(x))
        else:
            lo, hi = dom.low, dom.high
            fwd, inv = float, float
        span = max(hi - lo, 1e-12)
        g = [min(max(fwd(x), lo), hi) for x in gx] or [(lo + hi) / 2]
        b = [min(max(fwd(x), lo), hi) for x in bx]
        # bandwidth: range-scaled, shrinking with observation count
        sigma_g = max(span / max(len(g), 1) ** 0.5, span * 0.05)
        sigma_b = max(span / max(len(b), 1) ** 0.5, span * 0.05) if b \
            else span

        def density(x, pts, sigma):
            # uniform prior mixed in so g(x) never hits zero
            s = 1.0 / span
            for p in pts:
                s += math.exp(-0.5 * ((x - p) / sigma) ** 2) \
                    / (sigma * 2.5066282746310002)
            return s / (len(pts) + 1)

        best_x, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            center = self.rng.choice(g)
            x = min(max(self.rng.gauss(center, sigma_g), lo), hi)
            ratio = density(x, g, sigma_g) / density(x, b, sigma_b)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        out = inv(best_x)
        if isinstance(dom, Randint):
            out = min(max(out, dom.low), dom.high - 1)
        return out
