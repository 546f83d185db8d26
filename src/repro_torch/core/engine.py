"""Batched evaluation engine: pluggable executors over the pure cost kernel.

:class:`~repro_torch.core.cost.CachedEvaluator` is cache + counters; *how* a batch
of cache misses is computed is an :class:`Executor`'s job.  All backends run
the same pure kernel (:class:`~repro_torch.core.cost.CostKernel`), so they return
identical costs and search results never depend on the backend:

* ``serial``  — evaluate misses inline, one by one (exactly the
  pre-engine behaviour).
* ``process`` — shard a batch over a persistent ``ProcessPoolExecutor``.
  Each worker holds its own warm ``CostKernel`` (structure memo survives
  across batches); results are adopted into the parent evaluator's cache
  on join, like parallel ``compare``'s merge-on-join.  Wins when the
  structure half (schedule derivation) dominates — large graphs, cold
  caches, big GA generations.
* ``vector``  — compute each distinct node-set's structure once through the
  kernel memo, then batch the hardware-dependent half
  (:func:`~repro_torch.core.cost.finish_cost`) through NumPy in one vectorized
  pass.  Wins when one subgraph is probed at many hardware points
  (co-exploration populations).  Bit-identical to the scalar kernel; inputs
  that could round differently in float64 (``> 2**53``) or overflow int64
  products fall back to the scalar path element-wise.
* ``torch``   — same struct-of-arrays batching as ``vector``, but the
  capacity/streaming/weight-sharing arithmetic runs on a torch device
  (:mod:`repro_torch.kernels.finish_batch`): on a CUDA device one launch of
  a hand-written CUDA kernel per batch, on the CPU its plain torch version.
  A whole GA generation's distinct queries become one device call.  The
  same element-wise guards as ``vector`` route out-of-range inputs to the
  scalar path, so it is bit-identical to ``serial`` too.  The default
  backend, on the card unless the caller asks for the CPU.

Pick a backend by name via :func:`make_executor` — the seam the API layer's
``eval_backend``/``eval_jobs`` options thread through;
:func:`backend_status` answers "would that name resolve?" without building
anything (the CLI's pre-flight check).
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor
from dataclasses import fields as dataclass_fields
from typing import List, Optional, Sequence, Tuple

from repro_torch.obs import recorder as obs

from .cost import (
    STREAM_REASON,
    AcceleratorConfig,
    CostKernel,
    SubgraphCost,
    SubgraphStructure,
    finish_cost,
)
from .graph import Graph

EvalQuery = Tuple[frozenset, AcceleratorConfig]

# element-wise scalar-fallback guards for the array backends (vector/torch):
# float64 stays exact below 2**53; int64 products of two values below 2**31
# cannot overflow
_FLOAT_EXACT = 1 << 53
_PROD_SAFE = 1 << 31


def needs_scalar_fallback(st: SubgraphStructure,
                          acc: AcceleratorConfig) -> bool:
    """True when one query must take the scalar ``finish_cost`` path.

    The array backends batch the capacity/streaming arithmetic through
    float64-capable numerics, which are exact only while every operand stays
    below ``2**53`` and every int64 product's factors stay below ``2**31``;
    a failed schedule short-circuits in ``finish_cost`` and has nothing to
    batch.  The boundary is inclusive (``>=``) so the batched path never
    touches the first representable value that *could* round differently.
    The ``share * weight_total`` clause bounds the NoC product: with it (and
    the footprint bound on the block count), ``(share - 1) * ema_w`` stays
    below ``2**62`` even for a streamed sweep, so int64 cannot overflow.
    """
    return (st.sched_error is not None
            or max(st.footprint, st.weight_total) >= _PROD_SAFE
            or acc.weight_share_cores * st.weight_total >= _PROD_SAFE
            or max(acc.glb_bytes, acc.wbuf_bytes) >= _FLOAT_EXACT)


class Executor:
    """How a batch of distinct cost-kernel queries gets computed."""

    name = "abstract"

    def evaluate(self, kernel: CostKernel,
                 queries: Sequence[EvalQuery]) -> List[SubgraphCost]:
        raise NotImplementedError

    def close(self) -> None:  # release pools etc.; idempotent
        pass


class SerialExecutor(Executor):
    """Inline, one query at a time (pre-engine behaviour)."""

    name = "serial"

    def evaluate(self, kernel: CostKernel,
                 queries: Sequence[EvalQuery]) -> List[SubgraphCost]:
        return [kernel.cost(nodes, acc) for nodes, acc in queries]


# -- process backend ---------------------------------------------------------

def pool_mp_context():
    """The multiprocessing context every worker pool in the repo uses.

    Default start method (fork on Linux) while the process is torch-free:
    spawn/forkserver would re-import ``__main__`` and break REPL/stdin
    callers, and the workers themselves only run the pure kernel.  Once
    torch is imported, the process may hold a CUDA context and torch's
    thread pools; a forked child of such a process cannot use them and
    trips CPython's multithreaded-fork ``RuntimeWarning``.  So the pool
    switches to ``forkserver``: workers fork from a clean, torch-free server
    process instead of this one.  The kernel is deterministic, so results
    are identical under either context.
    """
    import multiprocessing as mp
    import sys

    if "torch" in sys.modules and "forkserver" in mp.get_all_start_methods():
        return mp.get_context("forkserver")
    return mp.get_context()


_WORKER_KERNEL: Optional[CostKernel] = None
_WORKER_CANON_SHIPPED = 0  # canonical entries already shipped to the parent

# wire order derived from the dataclass itself, so both protocol ends stay
# in sync across field reorders (and renames fail loudly at construction)
_COST_FIELDS = tuple(f.name for f in dataclass_fields(SubgraphCost))
_STRUCT_FIELDS = tuple(f.name for f in dataclass_fields(SubgraphStructure))


def _init_worker(g: Graph, out_tile: int, canonical: bool = True,
                 struct_cache_dir: Optional[str] = None) -> None:
    global _WORKER_KERNEL, _WORKER_CANON_SHIPPED
    struct_cache = None
    if struct_cache_dir:
        from .structcache import StructureCache

        struct_cache = StructureCache(struct_cache_dir)
    _WORKER_KERNEL = CostKernel(g, out_tile=out_tile, canonical=canonical,
                                struct_cache=struct_cache)
    _WORKER_CANON_SHIPPED = 0


def _worker_eval(
    accs: List[AcceleratorConfig],
    shard: List[Tuple[Tuple[int, ...], int]],
) -> Tuple[List[tuple], List[Tuple[tuple, tuple]]]:
    """Evaluate ``(nodes, acc-index)`` pairs; return plain field tuples.

    The compact protocol (an acc table instead of an acc per query, field
    tuples instead of dataclass instances) roughly halves the pickle cost,
    which is what bounds the process backend on cheap kernels.

    The second returned list ships the worker kernel's *new* canonical
    structure entries — those derived since this worker's previous shard —
    as ``(canonical_key, field-tuple)`` pairs with an empty ``nodes`` stamp
    (every canonical hit re-stamps it anyway).  The parent adopts them into
    its own kernel, so structures derived in workers keep paying off after
    the pool is gone (dict insertion order makes "new since last ship" a
    plain slice).
    """
    global _WORKER_CANON_SHIPPED
    assert _WORKER_KERNEL is not None, "worker pool not initialized"
    cost = _WORKER_KERNEL.cost
    out = []
    for nodes, ai in shard:
        c = cost(frozenset(nodes), accs[ai])
        out.append(tuple(getattr(c, name) for name in _COST_FIELDS))
    canon = _WORKER_KERNEL._canon
    fresh = []
    if len(canon) > _WORKER_CANON_SHIPPED:
        items = list(canon.items())[_WORKER_CANON_SHIPPED:]
        _WORKER_CANON_SHIPPED = len(canon)
        fresh = [(key,
                  tuple(() if name == "nodes" else getattr(st, name)
                        for name in _STRUCT_FIELDS))
                 for key, st in items]
    return out, fresh


class ProcessExecutor(Executor):
    """Shard batches over a persistent worker-process pool.

    The pool is created lazily on the first batch (bound to that kernel's
    graph/out_tile) and reused for every later batch, so workers keep their
    structure memos warm across GA generations.  ``close()`` (or evaluator
    ``close()``) shuts the pool down.
    """

    name = "process"

    def __init__(self, jobs: int = 2) -> None:
        self.jobs = max(1, int(jobs))
        self._pool: Optional[ProcessPoolExecutor] = None
        # the kernel the pool's workers were initialized for; held by
        # reference so a recycled id can never alias a different kernel
        self._pool_kernel: Optional[CostKernel] = None

    def _pool_for(self, kernel: CostKernel) -> ProcessPoolExecutor:
        if self._pool is not None and self._pool_kernel is not kernel:
            self.close()
        if self._pool is None:
            cache = kernel.struct_cache
            self._pool = ProcessPoolExecutor(
                max_workers=self.jobs,
                mp_context=pool_mp_context(),
                initializer=_init_worker,
                initargs=(kernel.g, kernel.out_tile, kernel.canonical,
                          str(cache.root) if cache is not None else None))
            self._pool_kernel = kernel
        return self._pool

    def evaluate(self, kernel: CostKernel,
                 queries: Sequence[EvalQuery]) -> List[SubgraphCost]:
        queries = list(queries)
        if len(queries) <= 2 * self.jobs:  # not worth the round-trips
            return [kernel.cost(nodes, acc) for nodes, acc in queries]
        pool = self._pool_for(kernel)
        # acc table: batches typically probe few distinct hardware points
        accs: List[AcceleratorConfig] = []
        acc_idx: dict = {}
        compact: List[Tuple[Tuple[int, ...], int]] = []
        for nodes, acc in queries:
            ai = acc_idx.get(id(acc))
            if ai is None:
                ai = acc_idx[id(acc)] = len(accs)
                accs.append(acc)
            compact.append((tuple(nodes), ai))
        n_shards = min(self.jobs, len(queries))
        rec = obs.current()
        with rec.span("executor.submit", backend=self.name,
                      shards=n_shards, queries=len(queries)):
            futures = [pool.submit(_worker_eval, accs, compact[i::n_shards])
                       for i in range(n_shards)]
        with rec.span("executor.join", backend=self.name):
            outs = [f.result() for f in futures]
        results: List[Optional[SubgraphCost]] = [None] * len(queries)
        for s, (shard_out, canon_wire) in enumerate(outs):
            for j, vals in enumerate(shard_out):
                results[s + j * n_shards] = SubgraphCost(
                    **dict(zip(_COST_FIELDS, vals)))
            if canon_wire:
                # adopt worker-derived canonical structures so they keep
                # serving hits in the parent (and in later serial batches)
                kernel.merge_canon({
                    key: SubgraphStructure(**dict(zip(_STRUCT_FIELDS, vals)))
                    for key, vals in canon_wire
                })
        return results  # type: ignore[return-value]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
            self._pool_kernel = None


# -- array backends (vector / torch) -------------------------------------------

class _BatchedFinishExecutor(Executor):
    """Shared struct-of-arrays structure for the array backends.

    Structures come from the kernel memo (one ``derive_schedule`` per
    distinct node set, like every backend).  The base class handles the
    guard partition (:func:`needs_scalar_fallback` lanes take the scalar
    ``finish_cost`` path element-wise), the int64 struct-of-arrays packing,
    and stitching array results back into :class:`SubgraphCost`s; a
    subclass only supplies :meth:`_finish_arrays` — the batched
    capacity/streaming/weight-sharing arithmetic itself.  Keeping one
    packing/stitching path means a new array backend cannot diverge from
    ``vector`` anywhere except inside the arithmetic the parity tests pin.
    """

    def _finish_arrays(self, fp, w_total, single, glb, wbuf, shared, share):
        """Batched ``finish_cost`` arithmetic over equal-length arrays.

        Returns ``(wr, n_blocks, ema_w, fp_out, noc, infeasible_buf,
        w_overflow, stream, feasible)`` arrays (int64 / bool), index-aligned
        with the inputs.
        """
        raise NotImplementedError

    def evaluate(self, kernel: CostKernel,
                 queries: Sequence[EvalQuery]) -> List[SubgraphCost]:
        import numpy as np

        queries = list(queries)
        results: List[Optional[SubgraphCost]] = [None] * len(queries)
        structs = [kernel.structure(nodes) for nodes, _ in queries]
        vec_idx = []
        for i, ((_, acc), st) in enumerate(zip(queries, structs)):
            if needs_scalar_fallback(st, acc):
                results[i] = finish_cost(st, acc)  # scalar fallback
            else:
                vec_idx.append(i)
        n_fallback = len(queries) - len(vec_idx)
        if n_fallback:
            obs.add("engine.scalar_fallback", n_fallback)
        if not vec_idx:
            return results  # type: ignore[return-value]
        # batches handed to the array arithmetic: for the torch backend on
        # a card, each is exactly one kernel launch
        obs.add("engine.array_batches")
        obs.add("engine.array_lanes", len(vec_idx))

        sts = [structs[i] for i in vec_idx]
        accs = [queries[i][1] for i in vec_idx]
        fp = np.array([s.footprint for s in sts], dtype=np.int64)
        w_total = np.array([s.weight_total for s in sts], dtype=np.int64)
        single = np.array([len(s.nodes) == 1 for s in sts], dtype=bool)
        glb = np.array([a.glb_bytes for a in accs], dtype=np.int64)
        wbuf = np.array([a.wbuf_bytes for a in accs], dtype=np.int64)
        shared = np.array([a.shared for a in accs], dtype=bool)
        # construction validates weight_share_cores >= 1, no clamp needed
        share = np.array([a.weight_share_cores for a in accs], dtype=np.int64)

        (wr, n_blocks, ema_w, fp_out, noc, infeasible_buf, w_overflow,
         stream, feasible) = self._finish_arrays(fp, w_total, single, glb,
                                                 wbuf, shared, share)

        for j, i in enumerate(vec_idx):
            st = sts[j]
            if infeasible_buf[j]:
                reason = ("shared buffer overflow" if shared[j]
                          else "global buffer overflow")
            elif w_overflow[j]:
                reason = "weight buffer overflow"
            elif stream[j]:
                reason = f"{STREAM_REASON} in {int(n_blocks[j])} blocks"
            else:
                reason = ""
            results[i] = SubgraphCost(
                nodes=st.nodes,
                ema_in=st.ema_in,
                ema_out=st.ema_out,
                ema_w=int(ema_w[j]),
                macs=st.macs,
                footprint=int(fp_out[j]),
                weight_resident=int(wr[j]),
                glb_access_bytes=st.glb_access_bytes,
                wbuf_access_bytes=int(wr[j]),
                noc_bytes=int(noc[j]),
                feasible=bool(feasible[j]),
                reason=reason,
            )
        return results  # type: ignore[return-value]


class VectorExecutor(_BatchedFinishExecutor):
    """NumPy-vectorized ``finish_cost`` over a whole batch.

    The capacity/streaming/weight-sharing arithmetic runs as one vectorized
    pass over the batch.  Wins when one subgraph is probed at many hardware
    points (co-exploration populations).
    """

    name = "vector"

    def _finish_arrays(self, fp, w_total, single, glb, wbuf, shared, share):
        import numpy as np

        wr = w_total // share
        glb_cap = glb
        wbuf_cap = np.where(shared, glb, wbuf)
        overflow = np.where(shared, fp + wr > glb_cap, fp > glb_cap)
        infeasible_buf = overflow & ~single
        stream = overflow & single
        # mirrors _stream_single_layer: math.ceil of a float64 true division
        n_blocks = np.maximum(
            np.ceil(fp / np.maximum(glb_cap, 1)).astype(np.int64), 1)
        ema_w = np.where(stream, wr * n_blocks, w_total)
        fp_out = np.where(stream, np.minimum(fp, glb_cap), fp)
        w_overflow = ~shared & ~single & ~infeasible_buf & (wr > wbuf_cap)
        feasible = ~(infeasible_buf | w_overflow)
        # §5.4.2 NoC charge, mirroring finish_cost: every DRAM-loaded weight
        # byte crosses the fabric to the share - 1 peer cores
        noc = (share - 1) * ema_w
        return (wr, n_blocks, ema_w, fp_out, noc, infeasible_buf, w_overflow,
                stream, feasible)


# -- torch backend ------------------------------------------------------------

class TorchExecutor(_BatchedFinishExecutor):
    """Batched ``finish_cost`` over a whole generation on a torch device.

    The same struct-of-arrays batching as ``vector``, evaluated through
    :func:`repro_torch.kernels.finish_batch.finish_cost_batch`: on a CUDA
    device one launch of the hand-written CUDA kernel per batch, on the CPU
    the kernel's plain torch version.  Bit-identical to ``serial``.
    """

    name = "torch"

    def __init__(self, device: str = "cuda") -> None:
        import torch

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "eval backend 'torch' on device cuda needs a CUDA GPU and "
                "none is available; pass device='cpu' to run on the CPU")

    def _finish_arrays(self, fp, w_total, single, glb, wbuf, shared, share):
        from repro_torch.kernels import finish_batch

        return finish_batch.finish_cost_batch(
            fp, w_total, single, glb, wbuf, shared, share,
            device=self.device)


BACKENDS = ("serial", "process", "vector", "torch")


def backend_status(backend: str) -> Tuple[bool, str]:
    """Would ``make_executor(backend)`` resolve the name?  ``(ok, why_not)``.

    The message here is the single source for both :func:`make_executor`
    errors and the CLI's ``--eval-backend`` pre-flight check: an unknown
    name lists the valid backends.
    """
    if backend not in BACKENDS:
        return (False,
                f"unknown eval backend {backend!r}; valid backends: "
                f"{', '.join(BACKENDS)}")
    return (True, "")


def make_executor(backend: Optional[str] = None, jobs: int = 1,
                  device: str = "cuda") -> Executor:
    """Resolve an ``eval_backend``/``eval_jobs`` pair to an executor.

    ``backend=None`` is ``torch``, placed on ``device`` (``"cuda"`` or
    ``"cpu"``).  ``jobs`` sizes the ``process`` backend's pool and is
    meaningless for every other backend, so ``jobs > 1`` with another
    backend raises a :class:`ValueError` rather than silently changing the
    backend or ignoring the workers.  Unknown names raise a
    :class:`ValueError` listing :data:`BACKENDS`.
    """
    if backend is None:
        backend = "torch"
    ok, why = backend_status(backend)
    if not ok:
        raise ValueError(why)
    if jobs and jobs > 1 and backend != "process":
        raise ValueError(
            f"eval_jobs={jobs} sizes the process backend's worker pool; "
            f"the {backend!r} backend runs no workers (pass "
            f"--eval-backend process)")
    if backend == "serial":
        return SerialExecutor()
    if backend == "process":
        return ProcessExecutor(jobs=jobs)
    if backend == "vector":
        return VectorExecutor()
    return TorchExecutor(device)
