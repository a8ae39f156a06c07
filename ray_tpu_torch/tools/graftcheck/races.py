"""Concurrency passes: ``shared-state-race`` and ``rng-discipline``
(the counterpart of ``ray_tpu/tools/graftcheck/races.py``).

The fleet is genuinely threaded — the controller reconciler
(serve/controller.py), handle long-poll listeners (serve/handle.py),
the metrics publisher (util/metrics.py), drain threads, the dashboard
server — while the serve engines and router run as asyncio tasks on
the event loop.  Many cross-context mutations are safe only because
CPython's GIL makes single bytecode-level container ops atomic; a
router and replicas in separate processes remove that accident.  These
passes enforce the discipline statically.

``shared-state-race`` — a per-class, interprocedural (within the
class) model of attribute access:

* :data:`THREAD_ROOTS` seeds which methods run on which execution
  contexts (``"ClassName.method" -> (context, ...)``); additionally
  every ``threading.Thread(target=self.m)`` seeds ``m`` with its own
  thread context, and async methods default to the shared
  ``event-loop`` context (asyncio tasks interleave only at awaits, so
  coroutines on one loop are a single context).
* Contexts propagate caller -> callee through ``self.m()`` calls.
* Attributes touched from >= 2 distinct contexts are *shared*; on
  shared attributes the pass flags non-GIL-atomic mutations outside a
  ``with self._lock`` block: read-modify-write (``x += 1``,
  ``x = f(x)``), check-then-act (test reads the attribute, body writes
  it), iteration over a mutable shared container, and multi-step init
  (>= 3 consecutive plain stores another thread can observe half-done).
* GIL-atomic single ops are whitelisted (flightrec's documented
  discipline): plain stores, subscript stores/deletes, and single
  mutator calls (``append``/``popleft``/``add``/...).
* Lock tracking is lexical plus two inferences: methods named
  ``*_locked`` are caller-locked by convention, and a method whose
  self-call sites ALL sit inside lock blocks is treated as lock-held.
* Locals assigned from an expression that reads a self attribute
  (``rep = self._reps.get(name)``) alias that attribute; snapshot
  copies (``list(self._reps.values())``) do not.  Parameters are never
  aliased — per-request record dicts are handed across methods
  deliberately and are engine-loop-local.

``rng-discipline`` — the serve path's bit-identity contracts
(deterministic replay, seeded chaos/traffic) require every random
stream to be seeded:

* torch draws (``torch.rand``/``randn``/``randint``/``randperm``/
  ``normal``/``multinomial``/``bernoulli`` and the ``.multinomial``/
  ``.bernoulli`` methods) must take an explicit ``generator=``: the
  process-global torch RNG is state no test can pin;
* seeds derived from wallclock/``os.urandom``/pid/uuid are
  unreproducible by construction (``torch.manual_seed``, a generator's
  ``.manual_seed``, ``random.Random``, numpy's seeds);
* unseeded module-level ``random.*`` / ``np.random.*`` draws use
  process-global state no test can pin.

(The JAX pass's key-reuse rule has no counterpart: a torch.Generator
carries its own state, so passing it twice draws two streams.)

Scope: ``shared-state-race`` covers ray_tpu_torch/serve/,
ray_tpu_torch/_private/ (not the vendored ``_private/_vendor/``) and
ray_tpu_torch/util/; ``rng-discipline`` covers ray_tpu_torch/serve/
(traffic and chaos generators included).  Both honor the standard
``# graftcheck: disable=<rule>(<reason>)`` waiver.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.tools.graftcheck.core import Violation

__all__ = ["THREAD_ROOTS", "shared_state_races", "rng_discipline"]

_RACE_SCOPES = ("ray_tpu_torch/serve/", "ray_tpu_torch/_private/",
                "ray_tpu_torch/util/")
_RNG_SCOPE = "ray_tpu_torch/serve/"

#: "ClassName.method" -> execution contexts that invoke it.  This is
#: the pass's ground truth for *who runs what*: per-class analysis
#: cannot see cross-class call edges (the engine loop calling
#: HealthMonitor.heartbeat), so the known entry points are seeded
#: here.  Methods reached only via self-calls inherit their callers'
#: contexts; a class whose methods all land on one context is skipped.
THREAD_ROOTS: Dict[str, Tuple[str, ...]] = {
    # healthwatch: engine wave loops stamp liveness, the router pump
    # probes and requeues, chaos injects faults, the controller
    # reconciler sweeps, and the dashboard/metrics threads read the
    # stats blocks.  In-process these mostly share the serve event
    # loop; the contexts model a multi-host split plus the
    # dashboard/publisher threads that exist today.
    "HealthMonitor.heartbeat": ("engine-wave-loop",),
    "HealthMonitor.note_idle": ("engine-wave-loop",),
    "HealthMonitor.note_fault": ("chaos-injector",),
    "HealthMonitor.note_requeued": ("router-pump",),
    "HealthMonitor.maybe_probe": ("engine-wave-loop", "router-pump"),
    "HealthMonitor.probe": ("controller-reconcile",),
    "HealthMonitor.state": ("router-pump",),
    "HealthMonitor.register": ("controller-reconcile",),
    "HealthMonitor.unregister": ("controller-reconcile",),
    "HealthMonitor.replicas": ("dashboard-handler",),
    "HealthMonitor.replica_block": ("dashboard-handler",),
    "HealthMonitor.fleet_block": ("dashboard-handler",
                                  "metrics-publisher"),
    "HealthMonitor.time_to_detect_ms": ("dashboard-handler",),
    # engine telemetry: recorded from the wave loop, scraped from the
    # dashboard thread, stall-swept from the health probe
    "EngineTelemetry.engine_stats": ("dashboard-handler",),
    "EngineTelemetry.stalled_requests": ("controller-reconcile",),
    "EngineTelemetry.record_enqueue": ("engine-wave-loop",),
    "EngineTelemetry.record_step": ("engine-wave-loop",),
    "EngineTelemetry.record_finish": ("engine-wave-loop",),
    # deployment handles: routing happens on the calling thread while
    # the long-poll listener thread swaps membership under it
    "DeploymentHandle.remote": ("api-caller",),
    "DeploymentHandle.call": ("api-caller",),
    "DeploymentHandle.queue_len": ("controller-reconcile",),
    "DeploymentHandle._apply_membership": ("handle-longpoll",),
    "_SharedListener.register": ("api-caller",),
    "_SharedListener.healthy": ("api-caller",),
    # serve controller: API surface runs on caller threads while the
    # reconcile loop (auto-seeded Thread target) and drain threads
    # mutate the same tables
    "ServeController.deploy": ("api-caller",),
    "ServeController.delete_deployment": ("api-caller",),
    "ServeController.get_replicas": ("api-caller",),
    "ServeController.listen_for_change": ("handle-longpoll",),
    "ServeController.get_routing_table": ("api-caller",),
    "ServeController.status": ("dashboard-handler",),
    # process-wide metric registry: metrics register from any thread,
    # the publisher (auto-seeded Thread target) flushes snapshots
    "_Registry.register": ("api-caller",),
    "_Registry.snapshot": ("dashboard-handler",),
}

#: self-attribute mutator calls that are one bytecode-level container
#: op under the GIL (flightrec's documented single-op discipline)
_ATOMIC_MUTATORS = frozenset({
    "append", "appendleft", "pop", "popleft", "add", "discard",
    "clear", "remove", "extend", "update", "setdefault",
    "put", "put_nowait", "get_nowait", "set", "release",
})
#: non-atomic container mutators we still count as writes
_ALL_MUTATORS = _ATOMIC_MUTATORS | {"insert", "sort", "reverse"}

#: calls that take a snapshot copy — a local built through these does
#: NOT alias the underlying shared attribute
_SNAPSHOT_FNS = frozenset({"list", "dict", "tuple", "set", "sorted",
                           "frozenset", "len", "sum", "max", "min",
                           "str", "repr", "int", "float", "bool"})

_LOCK_FACTORIES = ("Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore")


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 - exotic nodes
        return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' when node is ``self.x``, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _base_key(node: ast.AST, aliases: Dict[str, str]
              ) -> Optional[Tuple[str, str]]:
    """(attr, sub) storage key for an access target.

    ``self.x``            -> ("x", "")
    ``self.x[k]``         -> ("x", "[]")
    ``rep.y`` / ``rep.y[k]`` where rep aliases self._reps
                          -> ("_reps", "y")
    """
    if isinstance(node, ast.Subscript):
        node = node.value
    attr = _self_attr(node)
    if attr is not None:
        return (attr, "")
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id in aliases:
        return (aliases[node.value.id], node.attr)
    return None


def _reads_of(node: ast.AST, aliases: Dict[str, str]) -> Set[str]:
    """Base attrs read anywhere in an expression subtree (including
    through aliases and ``getattr(self, "x")``).  A ``self.m(...)``
    callee is method dispatch, not a data read — counting it would
    poison alias tracking through helper calls."""
    callees = {id(sub.func) for sub in ast.walk(node)
               if isinstance(sub, ast.Call)
               and isinstance(sub.func, ast.Attribute)
               and isinstance(sub.func.value, ast.Name)
               and sub.func.value.id == "self"}
    out: Set[str] = set()
    for sub in ast.walk(node):
        if id(sub) in callees:
            continue
        attr = _self_attr(sub)
        if attr is not None:
            out.add(attr)
        elif isinstance(sub, ast.Name) and sub.id in aliases:
            out.add(aliases[sub.id])
        elif (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == "getattr" and len(sub.args) >= 2
                and isinstance(sub.args[0], ast.Name)
                and sub.args[0].id == "self"
                and isinstance(sub.args[1], ast.Constant)
                and isinstance(sub.args[1].value, str)):
            out.add(sub.args[1].value)
    return out


class _Access:
    """One attribute access event inside a method body."""

    __slots__ = ("key", "sub", "kind", "locked", "lineno", "cta")

    def __init__(self, key: str, sub: str, kind: str, locked: bool,
                 lineno: int, cta: bool = False):
        self.key = key          # base self attribute
        self.sub = sub          # sub-attribute through an alias ("" = direct)
        self.kind = kind        # read|store|aug|rmw|mutcall|iterate|subscript
        self.locked = locked
        self.lineno = lineno
        self.cta = cta          # write guarded by a test that read the key

    @property
    def is_write(self) -> bool:
        return self.kind != "read" and self.kind != "iterate"

    def label(self) -> str:
        return f"self.{self.key}" + (f".{self.sub}" if self.sub else "")


class _MethodInfo:
    __slots__ = ("name", "node", "accesses", "calls", "thread_targets",
                 "is_async", "fully_locked")

    def __init__(self, name: str, node):
        self.name = name
        self.node = node
        self.accesses: List[_Access] = []
        #: (callee, lexically_locked) for each self.m() site
        self.calls: List[Tuple[str, bool]] = []
        #: methods handed to threading.Thread(target=self.m)
        self.thread_targets: List[str] = []
        self.is_async = isinstance(node, ast.AsyncFunctionDef)
        self.fully_locked = name.endswith("_locked")


def _find_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Self attributes holding threading.Lock/RLock/Condition/... —
    by construction site or by having "lock" in the name."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            attr = _self_attr(node.targets[0])
            if attr is None:
                continue
            if "lock" in attr.lower():
                locks.add(attr)
                continue
            v = node.value
            if isinstance(v, ast.Call):
                label = _unparse(v.func)
                if label.split(".")[-1] in _LOCK_FACTORIES:
                    locks.add(attr)
    return locks


def _is_lock_ctx(item: ast.withitem, locks: Set[str]) -> bool:
    expr = item.context_expr
    attr = _self_attr(expr)
    if attr is not None:
        return attr in locks or "lock" in attr.lower()
    # ``with lock:`` through a bare local (rare) — name heuristic
    return isinstance(expr, ast.Name) and "lock" in expr.id.lower()


def _is_snapshot(value: ast.expr) -> bool:
    return (isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in _SNAPSHOT_FNS)


class _MethodWalker:
    """Collects accesses/calls for one method, tracking lexical lock
    state, derived-alias locals, and check-then-act context."""

    def __init__(self, info: _MethodInfo, locks: Set[str]):
        self.info = info
        self.locks = locks
        self.aliases: Dict[str, str] = {}

    def walk(self):
        self._block(self.info.node.body,
                    locked=self.info.fully_locked, cta=set())

    # -- statement dispatch --------------------------------------------

    def _block(self, stmts, locked: bool, cta: Set[str]):
        run: List[Tuple[str, str, int]] = []  # multi-step-init window
        for stmt in stmts:
            stored = self._stmt(stmt, locked, cta)
            if stored is not None and not locked:
                run.append(stored)
            else:
                self._flush_run(run, locked)
                run = []
        self._flush_run(run, locked)

    def _flush_run(self, run, locked: bool):
        """>= 3 consecutive unlocked plain stores to distinct fields of
        one shared object read like initialization another thread can
        observe half-done."""
        if locked or len(run) < 3:
            return
        key = run[0][0]
        fields = {sub for k, sub, _ in run if k == key}
        if len([1 for k, _, _ in run if k == key]) >= 3 \
                and len(fields) >= 3:
            self.info.accesses.append(_Access(
                key, "", "multi-init", False, run[0][2]))

    def _stmt(self, stmt, locked: bool, cta: Set[str]
              ) -> Optional[Tuple[str, str, int]]:
        """Process one statement; returns (key, sub, lineno) when it is
        a plain store eligible for the multi-step-init window."""
        if isinstance(stmt, ast.With):
            inner = locked or any(_is_lock_ctx(i, self.locks)
                                  for i in stmt.items)
            for item in stmt.items:
                self._expr(item.context_expr, locked, cta)
            self._block(stmt.body, inner, cta)
            return None
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return None  # nested defs run elsewhere
        if isinstance(stmt, ast.If):
            tested = _reads_of(stmt.test, self.aliases)
            self._expr(stmt.test, locked, cta)
            self._block(stmt.body, locked, cta | tested)
            self._block(stmt.orelse, locked, cta | tested)
            return None
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._iterate(stmt.iter, locked)
            self._alias_from(stmt.target, stmt.iter)
            self._block(stmt.body, locked, cta)
            self._block(stmt.orelse, locked, cta)
            return None
        if isinstance(stmt, ast.While):
            tested = _reads_of(stmt.test, self.aliases)
            self._expr(stmt.test, locked, cta)
            self._block(stmt.body, locked, cta | tested)
            return None
        if isinstance(stmt, ast.Try):
            self._block(stmt.body, locked, cta)
            for h in stmt.handlers:
                self._block(h.body, locked, cta)
            self._block(stmt.orelse, locked, cta)
            self._block(stmt.finalbody, locked, cta)
            return None
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, locked, cta)
            key = _base_key(stmt.target, self.aliases)
            if key is not None:
                self._emit(key, "aug", locked, stmt.lineno, cta)
            return None
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else ([stmt.target] if stmt.value is not None
                             else []))
            value = stmt.value
            if value is None:
                return None
            self._expr(value, locked, cta)
            plain_store = None
            for t in targets:
                for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                           else [t]):
                    key = _base_key(el, self.aliases)
                    if key is None:
                        if isinstance(el, ast.Name):
                            self._alias_from(el, value)
                        continue
                    reads = _reads_of(value, self.aliases)
                    if key[0] in reads:
                        self._emit(key, "rmw", locked, stmt.lineno, cta)
                    elif isinstance(el, ast.Subscript):
                        self._emit(key, "subscript", locked,
                                   stmt.lineno, cta)
                    else:
                        self._emit(key, "store", locked,
                                   stmt.lineno, cta)
                        plain_store = (key[0], key[1], stmt.lineno)
            return plain_store
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                key = _base_key(t, self.aliases)
                if key is not None:
                    self._emit(key, "subscript", locked,
                               stmt.lineno, cta)
            return None
        if isinstance(stmt, (ast.Return, ast.Expr, ast.Raise,
                             ast.Assert, ast.Await)):
            val = getattr(stmt, "value", None) \
                or getattr(stmt, "exc", None) \
                or getattr(stmt, "test", None)
            if val is not None:
                self._expr(val, locked, cta)
            return None
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, locked, cta)
        return None

    # -- expression-level events ---------------------------------------

    def _alias_from(self, target, value):
        """Bind a Name target to the base attr its value reads (alias),
        unless the value is a snapshot copy or reads no self attr."""
        names = ([target.id] if isinstance(target, ast.Name)
                 else [e.id for e in getattr(target, "elts", [])
                       if isinstance(e, ast.Name)])
        if not names:
            return
        if _is_snapshot(value):
            for n in names:
                self.aliases.pop(n, None)
            return
        reads = sorted(_reads_of(value, self.aliases))
        for n in names:
            if len(reads) == 1:
                self.aliases[n] = reads[0]
            else:
                self.aliases.pop(n, None)

    def _iterate(self, iter_expr, locked: bool):
        node = iter_expr
        # unwrap ``self.x.items()/values()/keys()``
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("items", "values", "keys"):
            node = node.func.value
        key = _base_key(node, self.aliases)
        if key is not None:
            self.info.accesses.append(_Access(
                key[0], key[1], "iterate", locked,
                iter_expr.lineno))
            return
        self._expr(iter_expr, locked, set())

    def _emit(self, key: Tuple[str, str], kind: str, locked: bool,
              lineno: int, cta: Set[str]):
        self.info.accesses.append(_Access(
            key[0], key[1], kind, locked, lineno,
            cta=key[0] in cta))

    def _expr(self, node, locked: bool, cta: Set[str]):
        """Reads, self-calls, mutator calls, thread targets, and
        comprehension iterations inside one expression."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub, locked, cta)
            elif isinstance(sub, (ast.GeneratorExp, ast.ListComp,
                                  ast.SetComp, ast.DictComp)):
                for gen in sub.generators:
                    self._iterate(gen.iter, locked)
            else:
                attr = _self_attr(sub)
                if attr is not None and isinstance(sub.ctx, ast.Load):
                    self.info.accesses.append(_Access(
                        attr, "", "read", locked, sub.lineno))
                elif isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Load) \
                        and sub.id in self.aliases:
                    self.info.accesses.append(_Access(
                        self.aliases[sub.id], "", "read", locked,
                        sub.lineno))

    def _call(self, call: ast.Call, locked: bool, cta: Set[str]):
        f = call.func
        # threading.Thread(target=self.m) seeds a per-method context
        label = _unparse(f)
        if label.split(".")[-1] == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    attr = _self_attr(kw.value)
                    if attr is not None:
                        self.info.thread_targets.append(attr)
        if isinstance(f, ast.Attribute):
            owner = f.value
            if isinstance(owner, ast.Name) and owner.id == "self":
                # self.m(...) -> call edge (not an attribute access)
                self.info.calls.append((f.attr, locked))
                return
            key = _base_key(owner, self.aliases)
            if key is not None and f.attr in _ALL_MUTATORS:
                self.info.accesses.append(_Access(
                    key[0], key[1], "mutcall", locked, call.lineno,
                    cta=key[0] in cta))


# ---------------------------------------------------------------------------
# per-class analysis
# ---------------------------------------------------------------------------

def _class_methods(cls: ast.ClassDef) -> List[_MethodInfo]:
    out = []
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(_MethodInfo(node.name, node))
    return out


def _method_contexts(cls_name: str, methods: List[_MethodInfo]
                     ) -> Dict[str, Set[str]]:
    """Seeded contexts + fixpoint propagation through self-calls."""
    ctx: Dict[str, Set[str]] = {m.name: set() for m in methods}
    by_name = {m.name: m for m in methods}
    for m in methods:
        seeds = THREAD_ROOTS.get(f"{cls_name}.{m.name}")
        if seeds:
            ctx[m.name].update(seeds)
        elif m.is_async:
            ctx[m.name].add("event-loop")
        for tgt in m.thread_targets:
            if tgt in ctx:
                ctx[tgt].add(f"{tgt.lstrip('_')}-thread")
    changed = True
    while changed:
        changed = False
        for m in methods:
            for callee, _ in m.calls:
                if callee in by_name \
                        and not ctx[m.name] <= ctx[callee]:
                    ctx[callee] |= ctx[m.name]
                    changed = True
    return ctx


def _locked_methods(methods: List[_MethodInfo], cls_name: str
                    ) -> Set[str]:
    """Methods treated as lock-held for their whole body: ``*_locked``
    by convention, plus helpers whose self-call sites are ALL inside
    lock blocks (and that aren't independently seeded/threaded)."""
    by_name = {m.name: m for m in methods}
    held = {m.name for m in methods if m.fully_locked}
    changed = True
    while changed:
        changed = False
        for m in methods:
            if m.name in held or m.name == "__init__":
                continue
            if f"{cls_name}.{m.name}" in THREAD_ROOTS or m.is_async:
                continue
            if any(m.name in mm.thread_targets for mm in methods):
                continue
            sites = [(caller, locked) for mm in methods
                     for caller, locked in
                     [(mm.name, lk) for cal, lk in mm.calls
                      if cal == m.name]]
            if not sites:
                continue
            if all(locked or caller in held
                   for caller, locked in sites):
                held.add(m.name)
                changed = True
    return held


_KIND_TEXT = {
    "aug": "read-modify-write ({label} {op})",
    "rmw": "read-modify-write store to {label}",
    "multi-init": "multi-step re-initialization of {label} fields",
    "iterate": "iteration over mutable shared {label}",
    "cta": "check-then-act on {label}",
}


def shared_state_races(tree: ast.AST, rel: str) -> List[Violation]:
    rel_posix = rel.replace("\\", "/")
    if not any(rel_posix.startswith(s) for s in _RACE_SCOPES):
        return []
    out: List[Violation] = []
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef):
            out.extend(_check_class(cls, rel))
    return out


def _check_class(cls: ast.ClassDef, rel: str) -> List[Violation]:
    methods = _class_methods(cls)
    if not methods:
        return []
    locks = _find_lock_attrs(cls)
    for m in methods:
        _MethodWalker(m, locks).walk()
    ctx = _method_contexts(cls.name, methods)
    all_ctx = set().union(*ctx.values()) if ctx else set()
    if len(all_ctx) < 2:
        return []  # single execution context: no interleaving
    held = _locked_methods(methods, cls.name)

    # shared = attrs whose accessing methods span >= 2 contexts
    attr_ctx: Dict[str, Set[str]] = {}
    attr_written: Dict[str, bool] = {}
    for m in methods:
        if m.name == "__init__":
            continue  # construction happens-before publication
        for a in m.accesses:
            attr_ctx.setdefault(a.key, set()).update(ctx[m.name])
            if a.is_write:
                attr_written[a.key] = True
    shared = {k for k, c in attr_ctx.items()
              if len(c) >= 2 and k not in locks}

    out: List[Violation] = []
    for m in methods:
        if m.name == "__init__":
            continue
        m_locked = m.name in held
        for a in m.accesses:
            if a.key not in shared:
                continue
            if a.locked or m_locked:
                continue
            kind = a.kind
            if kind in ("store", "subscript", "mutcall"):
                # GIL-atomic single op — unless it acts on a value the
                # enclosing test just read (check-then-act)
                if not a.cta:
                    continue
                kind = "cta"
            elif kind == "read":
                continue
            elif kind == "iterate":
                if not attr_written.get(a.key):
                    continue
            elif kind in ("aug", "rmw") and a.cta:
                pass  # RMW message is the more specific one
            what = _KIND_TEXT.get(kind, kind).format(
                label=a.label(), op="+=/-=")
            ctxs = ", ".join(sorted(attr_ctx[a.key]))
            out.append(Violation(
                "shared-state-race",
                f"unlocked {what} in {cls.name}.{m.name}: "
                f"'{a.key}' is reached from contexts [{ctxs}] — hold "
                f"the class lock around the compound op, or mark a "
                f"deliberate GIL-atomic site with "
                f"disable=shared-state-race(<reason>)",
                file=rel, line=a.lineno))
    return out


# ---------------------------------------------------------------------------
# rng-discipline
# ---------------------------------------------------------------------------

#: seed/ctor calls whose argument must not come from wallclock/urandom
#: (a label ending in ".manual_seed" is one too: a generator's seed)
_SEED_SINKS = ("torch.manual_seed", "torch.cuda.manual_seed",
               "torch.cuda.manual_seed_all", "torch.seed",
               "random.Random", "random.seed",
               "np.random.RandomState", "np.random.default_rng",
               "np.random.seed", "numpy.random.RandomState",
               "numpy.random.default_rng", "numpy.random.seed")
#: wallclock/entropy sources that break bit-identity
_ENTROPY_CALLS = ("time.time", "time.time_ns", "time.monotonic",
                  "time.perf_counter", "os.urandom", "os.getpid",
                  "uuid.uuid4", "uuid.uuid1")
#: module-level stdlib random draws (process-global state)
_GLOBAL_RANDOM_FNS = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "getrandbits", "randbytes",
})
#: torch draws that take a ``generator=``; without one they read the
#: process-global torch RNG
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "multinomial", "bernoulli", "poisson",
})
#: the Tensor methods among them, flagged on any receiver
_TORCH_DRAW_METHODS = frozenset({"multinomial", "bernoulli",
                                 "bernoulli_", "uniform_", "normal_",
                                 "random_", "exponential_",
                                 "geometric_", "cauchy_",
                                 "log_normal_"})


def rng_discipline(tree: ast.AST, rel: str) -> List[Violation]:
    rel_posix = rel.replace("\\", "/")
    if not rel_posix.startswith(_RNG_SCOPE):
        return []
    out: List[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            label = _unparse(node.func)
            out.extend(_check_entropy_seed(node, label, rel))
            out.extend(_check_global_draw(node, label, rel))
            out.extend(_check_torch_draw(node, label, rel))
    return out


def _check_entropy_seed(call: ast.Call, label: str,
                        rel: str) -> List[Violation]:
    if label not in _SEED_SINKS and not label.endswith(".manual_seed"):
        return []
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Call) \
                    and _unparse(sub.func) in _ENTROPY_CALLS:
                return [Violation(
                    "rng-discipline",
                    f"{label}(...) seeded from "
                    f"'{_unparse(sub.func)}()' — wallclock/entropy "
                    f"seeds are unreproducible; thread an explicit "
                    f"seed through the config (the TrafficSpec.seed / "
                    f"ChaosConfig.seed idiom)",
                    file=rel, line=call.lineno)]
    return []


def _check_global_draw(call: ast.Call, label: str,
                       rel: str) -> List[Violation]:
    parts = label.split(".")
    if len(parts) == 2 and parts[0] == "random" \
            and parts[1] in _GLOBAL_RANDOM_FNS:
        pass
    elif len(parts) == 3 and parts[0] in ("np", "numpy") \
            and parts[1] == "random" \
            and parts[2] not in ("RandomState", "default_rng",
                                 "Generator"):
        pass
    else:
        return []
    return [Violation(
        "rng-discipline",
        f"module-level '{label}(...)' draws from process-global "
        f"unseeded RNG state on the serve path — use a seeded "
        f"instance (random.Random(seed) / np.random.RandomState("
        f"seed)) so traffic replay and chaos schedules stay "
        f"bit-identical",
        file=rel, line=call.lineno)]


def _check_torch_draw(call: ast.Call, label: str,
                      rel: str) -> List[Violation]:
    parts = label.split(".")
    if len(parts) == 2 and parts[0] == "torch" \
            and parts[1] in _TORCH_DRAWS:
        pass
    elif (isinstance(call.func, ast.Attribute)
            and call.func.attr in _TORCH_DRAW_METHODS
            and not (len(parts) == 2 and parts[0] == "torch")):
        pass
    else:
        return []
    if any(kw.arg == "generator" for kw in call.keywords):
        return []
    return [Violation(
        "rng-discipline",
        f"'{label}(...)' without generator= draws from the "
        f"process-global torch RNG on the serve path — pass a seeded "
        f"torch.Generator so sampling and replay stay bit-identical",
        file=rel, line=call.lineno)]
