"""Compiled-plan cache: skip lowering AND capture for repeated queries.

The port of ``repro.core.plan_cache``. ``PlanCache.get_or_compile(plan,
catalog)`` returns an executable ``run(tables) -> Table`` keyed by the
plan's structural+physical signature plus the schema signature of the
tables it scans (names, dtypes, static shapes) and the architecture of the
ML functions it calls. Keys are the JAX package's strings with the backend
names mapped (``jnp``->``torch``, ``pallas``->``kernel``): dtypes spell as
``float32``, shapes as ``(32,)``. Fresh table *contents* flow through as
arguments; weight *values* are assumed stable per function name.

Lowering is cost-driven (``core.costed_lowering`` against the cache's
``DeviceProfile``) and memoized per signature and profile epoch; the chosen
decision vector is part of ``key()`` (``#cl=...``). ``recalibrate(profile)``
bumps the epoch, so a changed decision selects a different executable.

Where ``jax.jit`` traces the lowered plan once, an executable here is built
once, at its first call:

- on a CUDA device, the physical plan runs once eagerly on a side stream
  (kernel libraries load, ``Atom.param`` places the weights on the card),
  then ``physical.run`` is captured into a ``torch.cuda.CUDAGraph`` over
  static input buffers shaped like the first call's tables. Each call copies
  the fresh contents into those buffers, replays the graph and returns
  outputs cloned out of the graph's pool, so a later replay never
  overwrites a result already returned. A capture that fails raises: there
  is no eager fallback;
- on the CPU the executable runs the memoized physical plan eagerly.

``traces`` counts those builds (a capture, on the card), so the reference's
"0 re-traces" reads "0 recaptures". An executable serves one schema: a
payload whose tensors differ in shape or dtype from its first call's
raises ``ValueError`` (``jax.jit`` would retrace; a graph cannot). An entry
the LRU evicts drops its graph, its pool and its static buffers; a caller
that still holds it rebuilds at its next call.

``get_or_compile_batched(plan, catalog, batch_size)`` (key suffix
``#vmap=B``) is the serving tier's entry point: B same-schema table dicts
are stacked on a leading axis and the plan body runs under
``torch.func.vmap`` (the engine kernels' custom operators fold the batch
into their rows, one launch each), then sliced per query; on the card the
stacking copies into static buffers and the vmapped body is one captured
graph.

The multi-device realizations (``get_or_compile_sharded``,
``get_or_compile_partitioned``, ``key(..., mesh=)``) are not ported yet
(ROADMAP.md, queue 1 item 12) and raise ``NotImplementedError``.

``LRUCache`` + ``CacheStats`` are the shared bounded-cache machinery.
"""
from __future__ import annotations

import dataclasses
import gc
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from repro_torch.core import cost, costed_lowering, ir
from repro_torch.core import physical as ph
from repro_torch.kernels.common import resolve_device
from repro_torch.relational.table import Table

NOT_PORTED = "the multi-device path is not ported yet (ROADMAP.md, queue 1 item 12)"


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate}


class LRUCache:
    """Size-capped mapping with LRU eviction and hit/miss accounting.
    ``on_evict(value)``, if given, is called on each evicted value."""

    def __init__(self, maxsize: int = 128,
                 on_evict: Optional[Callable[[Any], None]] = None):
        self.maxsize = max(1, int(maxsize))
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.stats = CacheStats()
        self._on_evict = on_evict

    def get(self, key: Hashable, default=None):
        if key in self._data:
            self._data.move_to_end(key)
            self.stats.hits += 1
            return self._data[key]
        self.stats.misses += 1
        return default

    def put(self, key: Hashable, value) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.maxsize:
            _, old = self._data.popitem(last=False)
            self.stats.evictions += 1
            if self._on_evict is not None:
                self._on_evict(old)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def clear(self) -> None:
        self._data.clear()


def scan_table_names(plan: ir.Plan) -> tuple:
    """The catalog tables a plan actually reads, sorted."""
    return tuple(sorted({n.table for n in ir.walk(plan.root)
                         if isinstance(n, ir.Scan)}))


def _dtype_name(dtype) -> str:
    """A dtype as numpy (and the JAX package's keys) spell it: ``float32``."""
    return str(dtype).removeprefix("torch.")


def schema_signature(catalog: ir.Catalog,
                     names: Optional[tuple] = None) -> str:
    """Static catalog shape: anything that changes the captured program.

    ``names`` restricts the signature to the given tables (``PlanCache.key``
    passes the plan's scanned tables, so an unrelated catalog entry cannot
    force a false miss); ``None`` signs the whole catalog.
    """
    if names is None:
        names = sorted(catalog.tables)
    parts = []
    for name in names:
        t = catalog.tables[name]
        cols = ",".join(f"{c}:{_dtype_name(t.columns[c].dtype)}:"
                        f"{tuple(t.columns[c].shape)}"
                        for c in sorted(t.columns))
        parts.append(f"{name}[{t.capacity}]({cols})")
    return ";".join(parts)


def _plan_fn_names(plan: ir.Plan):
    names = set()

    def from_expr(e: ir.Expr):
        if isinstance(e, ir.Call):
            names.add(e.fn)
        for c in e.children():
            from_expr(c)

    for node in ir.walk(plan.root):
        if isinstance(node, ir.Filter):
            from_expr(node.pred)
        elif isinstance(node, ir.Project):
            for _, e in node.outputs:
                from_expr(e)
        elif isinstance(node, (ir.BlockedMatmul, ir.ForestRelational)):
            names.add(node.fn)
    return sorted(names)


def _param_sig(v) -> str:
    if isinstance(v, torch.Tensor):
        return f"{tuple(v.shape)}:{_dtype_name(v.dtype)}"
    return f"{getattr(v, 'shape', v)}:{getattr(v, 'dtype', '')}"


def registry_signature(plan: ir.Plan) -> str:
    """Architecture signature of every ML function the plan references:
    atom kinds + parameter shapes/dtypes (no weight hashing). A weight
    update that keeps name AND shapes must bump the function name (or use a
    fresh cache) to invalidate."""
    parts = []
    for name in _plan_fn_names(plan):
        try:
            fn = plan.registry.get(name)
        except KeyError:
            parts.append(f"{name}:?")
            continue
        if fn.graph is None:
            parts.append(f"{name}:opaque")
            continue
        atoms = []
        for n in fn.graph.nodes:
            ps = ",".join(f"{k}={_param_sig(v)}"
                          for k, v in sorted(n.atom.params.items()))
            atoms.append(f"{n.atom.kind}({ps})@{n.atom.backend}")
        parts.append(f"{name}:{'|'.join(atoms)}")
    return ";".join(parts)


# ---------------------------------------------------------------------------
# executables
# ---------------------------------------------------------------------------
# A payload crosses into an executable as a pytree, {name: (columns, valid)},
# which torch.func.vmap maps over and a graph keeps static buffers of.

def _tree(tables: Dict[str, Table], names) -> dict:
    """The payload's scanned tables in a canonical order (tables and columns
    sorted), so that its leaves line up with an executable's buffers."""
    return {n: ({c: tables[n].columns[c] for c in sorted(tables[n].columns)},
                tables[n].valid) for n in names}


def _tables(tree: dict) -> Dict[str, Table]:
    return {n: Table(columns=dict(cols), valid=valid)
            for n, (cols, valid) in tree.items()}


def _leaves(tree):
    """The tensors of a nested dict/tuple/list, in a fixed order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_device(tree: dict, device: torch.device) -> dict:
    return _tree_map(lambda v: v.to(device), tree)


def _spec(tree: dict) -> tuple:
    return tuple((n, tuple((c, tuple(v.shape), v.dtype)
                           for c, v in sorted(cols.items())),
                  tuple(valid.shape))
                 for n, (cols, valid) in sorted(tree.items()))


def _clone_table(t: Table) -> Table:
    return Table(columns={k: v.clone() for k, v in t.columns.items()},
                 valid=t.valid.clone())


class CapturedGraph:
    """``body`` of a nested dict/tuple/list of tensors captured into one
    CUDA graph on ``device``: static input buffers (copies of ``example``),
    the graph, its outputs in the graph's private pool (``replay`` returns
    them; copy what must outlive the next replay), the host seconds of the
    warm-up and of the capture, and the bytes the pool reserved. The body
    runs once eagerly on a side stream first, so that libraries load and
    lazily placed tensors (weights) exist before the capture; a capture
    that fails raises. Any function of tensors whose shapes are static fits:
    a plan body here, the learned embedder's forwards, and the LM server's
    decode step (``launch.serve.Server``), whose params and cache are state
    that the body reads and writes in place, not part of ``example``."""

    def __init__(self, body: Callable[[Any], Any], example: Any,
                 device: torch.device):
        self.static_in = _tree_map(lambda v: v.to(device, copy=True), example)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm-up: libraries load, weights move
            body(self.static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        # torch.cuda.graph empties the allocator's cache before it captures;
        # doing it first makes the growth of the reserved memory the
        # segments of the graph's private pool
        torch.cuda.synchronize(device)
        self.warmup_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection while capturing: a collected object
        # that owns a graph would destroy it mid-capture, which CUDA
        # refuses and which invalidates this capture
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.static_out = body(self.static_in)
        finally:
            if gc_was_enabled:
                gc.enable()
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self, inputs: Any = None) -> Any:
        """Copy ``inputs`` (shaped like the example) into the static
        buffers, if given, and replay the graph."""
        if inputs is not None:
            for dst, src in zip(_leaves(self.static_in), _leaves(inputs)):
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        return self.static_out


class _Executable:
    """One cached executable over the scanned tables ``names``: built
    (``PlanCache.traces`` += 1) at its first call, dropped by ``release``.

    ``batch_size`` None takes one ``{name: Table}`` dict and returns a
    Table; an int B takes a sequence of B dicts and returns B Tables, run
    as one vmapped body."""

    def __init__(self, cache: "PlanCache", pplan: ph.PhysicalPlan, names: tuple,
                 kind: str, batch_size: Optional[int] = None):
        # a weak reference: no cycle with the cache, so an executable and
        # its graph go as soon as the last reference does
        self._cache, self.pplan, self.names = weakref.ref(cache), pplan, names
        self.kind, self.batch_size = kind, batch_size
        self.device = cache.device
        self._spec = None
        self.captured: Optional[CapturedGraph] = None

    # -- the plan body over a payload tree ---------------------------------
    def _run(self, tree: dict) -> Table:
        return ph.run(self.pplan, _tables(tree))

    def _run_batched(self, stacked: dict) -> Table:
        def one(tree):
            out = self._run(tree)
            return dict(out.columns), out.valid
        cols, valid = torch.func.vmap(one)(stacked)
        return Table(columns=cols, valid=valid)

    # -- build / release ---------------------------------------------------
    @property
    def built(self) -> bool:
        return self._spec is not None

    @property
    def pool_bytes(self) -> int:
        """Device bytes the capture reserved for the graph's pool (0 on the
        CPU and before the first call)."""
        return self.captured.pool_bytes if self.captured is not None else 0

    def release(self) -> None:
        """Drop the graph, its pool and the static buffers (LRU eviction)."""
        self.captured = None
        self._spec = None

    def _admit(self, specs: list) -> bool:
        """Whether this call builds the executable: its first call does. A
        payload whose tables differ in shape or dtype from the schema it was
        built for, or from each other, raises ValueError. Both count in
        ``traces``, as a ``jax.jit`` (re)trace does, failed ones included."""
        if self._spec is not None and all(s == self._spec for s in specs):
            return False
        cache = self._cache()
        if cache is not None:
            cache.traces += 1
        if self._spec is not None or any(s != specs[0] for s in specs):
            raise ValueError(f"{self.kind} executable: payload tensors differ in "
                             "shape or dtype from its schema")
        return True

    def _build(self, example: dict, spec: tuple) -> None:
        if self.device.type == "cuda":
            body = self._run if self.batch_size is None else self._run_batched
            self.captured = CapturedGraph(body, example, self.device)
        self._spec = spec

    # -- calls -------------------------------------------------------------
    def __call__(self, tables):
        if self.batch_size is None:
            return self._call_one(tables)
        return self._call_batched(tables)

    def _call_one(self, tables: Dict[str, Table]) -> Table:
        tree = _tree(tables, self.names)
        spec = _spec(tree)
        if self._admit([spec]):
            self._build(tree, spec)
        if self.captured is None:  # the CPU: the memoized plan, eagerly
            return self._run(_to_device(tree, self.device))
        return _clone_table(self.captured.replay(tree))

    def _call_batched(self, tables_seq) -> tuple:
        if len(tables_seq) != self.batch_size:
            raise ValueError(
                f"{self.kind} executable compiled for batch_size="
                f"{self.batch_size}, got {len(tables_seq)} table dicts")
        trees = [_tree(t, self.names) for t in tables_seq]
        specs = [_spec(t) for t in trees]
        if self._admit(specs):
            self._build(_stack_trees(trees, self.device), specs[0])
        if self.captured is None:
            out = self._run_batched(_stack_trees(trees, self.device))
        else:
            for dst, *srcs in zip(_leaves(self.captured.static_in),
                                  *(_leaves(t) for t in trees)):
                torch.stack([s.to(self.device) for s in srcs], out=dst)
            out = _clone_table(self.captured.replay())
        return tuple(unstack_table(out, i) for i in range(self.batch_size))


def _stack_trees(trees, device) -> dict:
    return {n: ({c: torch.stack([t[n][0][c].to(device) for t in trees])
                 for c in cols},
                torch.stack([t[n][1].to(device) for t in trees]))
            for n, (cols, _) in trees[0].items()}


def _release(entry) -> None:
    if isinstance(entry, _Executable):
        entry.release()


class PlanCache:
    """Signature-keyed cache of compiled (captured) plan executables on
    ``device``: ``cuda`` unless the caller names one. The device is resolved
    at first use and raises there without CUDA, so that the module-level
    ``GLOBAL_PLAN_CACHE`` can be made on a machine without a card."""

    def __init__(self, maxsize: int = 64,
                 profile: Optional[cost.DeviceProfile] = None, device=None):
        self._cache = LRUCache(maxsize, on_evict=_release)
        self.traces = 0  # executable builds: captures on the card
        self._profile = profile  # lazily detected; see profile property
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self.profile_epoch = 0   # bumped by recalibrate()
        # per-(signature, backend, epoch) costed-lowering results: warm
        # dispatches pay one LRU lookup, not a candidate enumeration
        self._lowered = LRUCache(256)

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    @property
    def stats(self) -> CacheStats:
        return self._cache.stats

    @property
    def profile(self) -> cost.DeviceProfile:
        """The device profile lowering decisions are costed against: a copy
        of ``cost.default_profile(device)``, since a server may set its
        memory budget and calibration replaces it."""
        if self._profile is None:
            self._profile = dataclasses.replace(cost.default_profile(self.device))
        return self._profile

    def recalibrate(self, profile: cost.DeviceProfile) -> None:
        """Install a (feedback-calibrated) profile. Bumping the epoch
        re-derives lowering decisions on the next dispatch of every
        signature; signatures whose decisions change get fresh cache keys
        (no stale-executable aliasing), unchanged ones keep their entry."""
        self._profile = profile
        self.profile_epoch += 1

    def base_key(self, plan: ir.Plan, catalog: ir.Catalog) -> str:
        return (plan.signature()
                + "@" + schema_signature(catalog, scan_table_names(plan))
                + "@" + registry_signature(plan))

    def key(self, plan: ir.Plan, catalog: ir.Catalog, *, mesh=None,
            backend: Optional[str] = None) -> str:
        """Full executable key: base signature + the realization vector the
        costed lowering chose under the cache's current profile. ``mesh``
        (the partitioned realization's key) raises ``NotImplementedError``."""
        if mesh is not None:
            raise NotImplementedError(f"PlanCache.key(mesh=...): {NOT_PORTED}")
        base = self.base_key(plan, catalog)
        low = self._lowered_for(plan, catalog, base, None)
        return base + "#cl=" + low.signature

    def _lowered_for(self, plan: ir.Plan, catalog: ir.Catalog,
                     keyed: str, backend: Optional[str], ways: int = 1
                     ) -> costed_lowering.Lowered:
        """Costed-lowering result for ``plan``, memoized per (signature,
        backend, profile epoch, *catalog object*): compaction decisions are
        sized from the catalog's data, which the schema-only signature cannot
        see. The weakref guards id reuse by a freed catalog."""
        mk = (keyed, self.profile_epoch, id(catalog))
        hit = self._lowered.get(mk)
        if hit is not None and hit[0]() is catalog:
            return hit[1]
        low = costed_lowering.lower_costed(plan, catalog,
                                           profile=self.profile,
                                           backend=backend, ways=ways)
        self._lowered.put(mk, (weakref.ref(catalog), low))
        return low

    @staticmethod
    def _strip_cl(key: str) -> str:
        """Drop a stale ``#cl=`` decision suffix, and any ``#be=``
        realization suffix preceding it, from a caller-memoized key."""
        return key.split("#be=", 1)[0].split("#cl=", 1)[0]

    def get_or_compile(self, plan: ir.Plan, catalog: ir.Catalog,
                       *, backend: Optional[str] = None,
                       cache_key: Optional[str] = None
                       ) -> Callable[[Dict[str, Table]], Table]:
        """``cache_key`` lets hot callers (the serving tier memoizes it at
        admission) skip the signature walk on warm dispatches; it must equal
        ``self.key(plan, catalog)``."""
        base = self._strip_cl(cache_key if cache_key is not None
                              else self.base_key(plan, catalog))
        if backend is not None:
            base = f"{base}#be={backend}"
        low = self._lowered_for(plan, catalog, base, backend)
        key = base + "#cl=" + low.signature
        fn = self._cache.get(key)
        if fn is None:
            fn = _Executable(self, low.plan, scan_table_names(plan), "plain")
            self._cache.put(key, fn)
        return fn

    def get_or_compile_batched(self, plan: ir.Plan, catalog: ir.Catalog,
                               batch_size: int, *,
                               backend: Optional[str] = None,
                               cache_key: Optional[str] = None):
        """One vmapped dispatch over ``batch_size`` same-signature queries.

        Returns ``run(tables_seq) -> tuple[Table, ...]`` taking a sequence
        of ``batch_size`` same-schema ``{name: Table}`` dicts. Stacking onto
        the leading batch axis, the vmapped plan body and the per-query
        slices are one executable (on the card: the copy into stacked static
        buffers, one graph replay, one clone of the outputs). The batch size
        is part of the key; a call with another count raises ValueError."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        base = self._strip_cl(cache_key if cache_key is not None
                              else self.base_key(plan, catalog))
        if backend is not None:
            base = f"{base}#be={backend}"
        low = self._lowered_for(plan, catalog, base, backend)
        key = base + "#cl=" + low.signature + f"#vmap={batch_size}"
        return self._get_or_compile_stacked(key, low.plan, plan, batch_size,
                                            kind="batched")

    def _get_or_compile_stacked(self, key: str, pplan, plan: ir.Plan,
                                batch_size: int, *, kind: str):
        fn = self._cache.get(key)
        if fn is None:
            fn = _Executable(self, pplan, scan_table_names(plan), kind,
                             batch_size=batch_size)
            self._cache.put(key, fn)
        return fn

    def get_or_compile_sharded(self, plan, catalog, batch_size, mesh, *,
                               cache_key=None):
        raise NotImplementedError(f"get_or_compile_sharded: {NOT_PORTED}")

    def get_or_compile_partitioned(self, plan, catalog, mesh, *, backend=None,
                                   cache_key=None):
        raise NotImplementedError(f"get_or_compile_partitioned: {NOT_PORTED}")

    def __call__(self, plan: ir.Plan, catalog: ir.Catalog) -> Table:
        """Convenience: compile-or-reuse, then execute on catalog tables."""
        return self.get_or_compile(plan, catalog)(dict(catalog.tables))


def stack_tables(tables_list) -> Dict[str, Table]:
    """Stack N same-schema ``{name: Table}`` dicts on a new leading axis."""
    if not tables_list:
        raise ValueError("stack_tables needs at least one table dict")
    first = tables_list[0]
    return {n: Table(columns={c: torch.stack([t[n].columns[c] for t in tables_list])
                              for c in first[n].columns},
                     valid=torch.stack([t[n].valid for t in tables_list]))
            for n in first}


def unstack_table(batched: Table, i: int) -> Table:
    """Slice query ``i``'s result out of a batched executable's output."""
    return Table(columns={k: v[i] for k, v in batched.columns.items()},
                 valid=batched.valid[i])


GLOBAL_PLAN_CACHE = PlanCache()
