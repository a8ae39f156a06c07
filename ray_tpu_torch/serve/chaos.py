"""Seeded chaos fault injection for the serve fleet.

A copy of ``ray_tpu/serve/chaos.py``.  ``build_llm_fleet`` and its
router (``serve/router.py``) attach the injector to each replica's
engine (``engine._chaos``).

Healthwatch (serve/health.py) is only trustworthy if its detection
paths are *exercised*, deterministically, in tests and benches — this
module is the fault generator.  A frozen :class:`ChaosConfig` names
the faults; :class:`ChaosInjector` is the runtime the fleet threads
through ``build_llm_fleet(chaos=)``:

* **freeze** — one replica's engine loop stops processing for
  ``freeze_waves`` wave windows after ``freeze_after_waves`` real
  waves: the loop polls ``asyncio.sleep(freeze_poll_ms)`` without
  heartbeating, exactly what a wedged host looks like to the monitor
  (heartbeats stop, admitted requests go token-silent, queued
  requests strand).  The freeze instant stamps
  ``HealthMonitor.note_fault`` so the DEAD transition carries
  ``time_to_detect_ms``.
* **token delay** — one replica's waves each stall an extra
  ``delay_token_ms`` for ``delay_token_waves`` waves: the loop still
  heartbeats but its requests go token-silent, the stall-detection
  path (heartbeat-death cannot catch this one).
* **handoff drop** — the Nth prefill→decode handoff package is
  dropped in the router (disaggregated fleets): the router journals
  ``handoff_dropped`` and recovers by re-running the request's prompt
  from scratch on a decode-capable replica, so the caller still gets
  a bit-identical (greedy) result.

Everything is inert unless armed: ``build_llm_fleet(chaos=None)``
(the default) attaches nothing to the engines — the hot path's only
cost is one ``is None`` check per wave — and a default
``ChaosConfig()`` arms no fault.  Replica targeting is by build-order
index (``bind`` order: prefill replicas first, then decode/both, the
fleet listing order) or by full replica name.

Clock discipline matches telemetry: monotonic ``perf_counter`` only,
and the only sleeps are ``asyncio.sleep`` awaited by the engine loop.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Union

__all__ = ["ChaosConfig", "ChaosInjector"]


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One fleet's fault plan.  ``freeze_replica`` /
    ``delay_token_replica`` select the victim by build-order index
    (int) or replica name (str); None disarms that fault.
    ``drop_handoff_nth`` drops the Nth handoff package (1-based; 0
    never drops).  ``seed`` keys any randomized choices so a chaos
    run replays exactly."""

    seed: int = 0
    freeze_replica: Optional[Union[int, str]] = None
    freeze_after_waves: int = 2
    freeze_waves: int = 20
    freeze_poll_ms: float = 5.0
    delay_token_replica: Optional[Union[int, str]] = None
    delay_token_ms: float = 0.0
    delay_token_waves: int = 0
    drop_handoff_nth: int = 0

    def __post_init__(self):
        if self.freeze_after_waves < 0 or self.freeze_waves < 0:
            raise ValueError(
                "freeze_after_waves/freeze_waves must be >= 0, got "
                f"{self.freeze_after_waves}/{self.freeze_waves}")
        if self.freeze_poll_ms <= 0:
            raise ValueError(
                f"freeze_poll_ms must be > 0, got "
                f"{self.freeze_poll_ms}")
        if self.delay_token_ms < 0 or self.delay_token_waves < 0:
            raise ValueError(
                "delay_token_ms/delay_token_waves must be >= 0, got "
                f"{self.delay_token_ms}/{self.delay_token_waves}")
        if self.drop_handoff_nth < 0:
            raise ValueError(
                f"drop_handoff_nth must be >= 0, got "
                f"{self.drop_handoff_nth}")

    def any_faults(self) -> bool:
        return ((self.freeze_replica is not None
                 and self.freeze_waves > 0)
                or (self.delay_token_replica is not None
                    and self.delay_token_ms > 0
                    and self.delay_token_waves > 0)
                or self.drop_handoff_nth > 0)


class ChaosInjector:
    """Runtime fault state shared by a fleet's replicas.  The engine
    loop asks :meth:`frozen` / :meth:`token_delay_s` per wave; the
    router asks :meth:`should_drop_handoff` per package.  Single
    event-loop discipline (same as the router) — no lock needed."""

    def __init__(self, config: ChaosConfig, monitor=None):
        self.config = config
        #: HealthMonitor (or None) — fault instants stamp note_fault
        #: so detection latency is measured from injection
        self._monitor = monitor
        self._rng = random.Random(config.seed)
        self._names: List[str] = []        # bind order = replica index
        self._waves: Dict[str, int] = {}   # real (unfrozen) waves run
        self._frozen_polls: Dict[str, int] = {}
        self._delayed_waves: Dict[str, int] = {}
        self._fault_noted: set = set()
        self._handoffs_seen = 0
        self.dropped_handoffs = 0
        self.freeze_poll_s = config.freeze_poll_ms / 1e3

    def bind(self, replica: str) -> None:
        """Register one replica in fleet build order — the order an
        int ``freeze_replica`` / ``delay_token_replica`` indexes."""
        if replica not in self._names:
            self._names.append(replica)

    def _matches(self, which: Optional[Union[int, str]],
                 replica: str) -> bool:
        if which is None:
            return False
        if isinstance(which, int):
            return (0 <= which < len(self._names)
                    and self._names[which] == replica)
        return replica == which

    def _note_fault(self, replica: str, kind: str) -> None:
        key = (replica, kind)
        if key in self._fault_noted:
            return
        self._fault_noted.add(key)
        if self._monitor is not None:
            self._monitor.note_fault(replica, kind=kind)

    # -- engine-loop hooks (serve/llm.py _engine) ----------------------

    def frozen(self, replica: str) -> bool:
        """Is this wave frozen for `replica`?  True for
        ``freeze_waves`` consecutive poll windows once the replica has
        run ``freeze_after_waves`` real waves; the engine loop then
        awaits ``freeze_poll_s`` and re-asks instead of processing
        (and, crucially, instead of heartbeating)."""
        cfg = self.config
        if cfg.freeze_waves > 0 \
                and self._matches(cfg.freeze_replica, replica) \
                and self._waves.get(replica, 0) \
                >= cfg.freeze_after_waves:
            polls = self._frozen_polls.get(replica, 0)
            if polls < cfg.freeze_waves:
                self._frozen_polls[replica] = polls + 1
                self._note_fault(replica, "freeze")
                return True
        self._waves[replica] = self._waves.get(replica, 0) + 1
        return False

    def token_delay_s(self, replica: str) -> float:
        """Extra per-wave stall for the delay victim (0.0 otherwise):
        tokens still flow, just ``delay_token_ms`` late — the
        token-silence shape only the stall sweep can detect."""
        cfg = self.config
        if cfg.delay_token_ms <= 0 \
                or not self._matches(cfg.delay_token_replica, replica):
            return 0.0
        done = self._delayed_waves.get(replica, 0)
        if done >= cfg.delay_token_waves:
            return 0.0
        self._delayed_waves[replica] = done + 1
        self._note_fault(replica, "token_delay")
        return cfg.delay_token_ms / 1e3

    # -- router hook (serve/router.py _forward_handoff) ----------------

    def should_drop_handoff(self) -> bool:
        """Drop the Nth handoff package (1-based counter over every
        package the router forwards)."""
        if self.config.drop_handoff_nth <= 0:
            return False
        self._handoffs_seen += 1
        if self._handoffs_seen == self.config.drop_handoff_nth:
            self.dropped_handoffs += 1
            return True
        return False

    def stats(self) -> Dict[str, Any]:
        return {
            "armed": self.config.any_faults(),
            "seed": self.config.seed,
            "replicas": list(self._names),
            "frozen_polls": dict(self._frozen_polls),
            "delayed_waves": dict(self._delayed_waves),
            "handoffs_seen": self._handoffs_seen,
            "dropped_handoffs": self.dropped_handoffs,
        }
