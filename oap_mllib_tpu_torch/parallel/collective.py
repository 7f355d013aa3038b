"""Collectives over a mesh: the counterparts of the JAX package's
``parallel/collective.py`` ``psum``, ``all_gather`` and ``ppermute``,
which ran inside ``shard_map`` bodies, and of the host collectives
``process_allgather`` and the ALS shuffle's ``all_to_all``.

A collective takes the per-rank tensors of a group, each on its rank's
device, and returns one tensor per rank on that rank's device.  These
are plain torch code, as XLA's psum was compiled code and not a Pallas
kernel; the ring reduction that replaces the moment psums is the
hand-written kernel of ops/cuda/ring_kernel.py.

In a world of several processes (parallel/bootstrap.py) a group may hold
ranks of other processes.  Every process then calls the collective with
the tensors of its own ranks; each moves them to the host, one gloo
``all_gather`` brings in every other process's parts, and every process
folds each of its groups in **rank order**, ``acc = parts[0]; acc = acc
+ p ...``, exactly as one process folds: the bits equal the one-process
mesh's, and every rank holds the same sum.  A collective whose groups
all lie inside processes moves nothing between them.  The decision is a
pure function of the mesh, so every process issues the same
collectives.

:func:`psum_group`, :func:`all_gather_group` and :func:`ppermute` take
one group's tensors as a list, for callers that run a subset of the
mesh's ranks (the block ALS route runs the first model column); across
processes they take the whole ``group`` of ranks and the ``mesh``, and
the list holds the tensors of the group's local ranks.

A census counts every collective by (op, axis), as the JAX package's
``_note_emitted`` counts the collectives emitted into its programs, so
a test can count psums against ring reductions: :func:`emitted`,
:func:`reset_census`.  Each reduction of one group counts once; a
:func:`process_allgather` or :func:`all_to_all` counts once a call.

Every host exchange across processes (``_all_gather_host``, which every
cross-process collective and the streamed passes' host reductions go
through, and :func:`all_to_all`) is the ``collective.dispatch`` fault
site (utils/faults.py).  Those two, :func:`barrier` and :func:`agree`
(which the growth and release of K5's cross-process workspace go
through; a K5 call itself signals on the card) run their gloo call
under the recovery plane's watcher (utils/recovery.guarded_dispatch): a
peer that died or never arrives raises ``PeerAbortError`` or
``CollectiveTimeoutError`` on every survivor.

Each of those host dispatches is instrumented (:func:`_instrumented`,
the JAX package's facade): ``oap_collective_ops_total``,
``oap_collective_bytes_total`` and ``oap_collective_dispatch_seconds``
by op, ``Span.note_collective`` on the thread's active span, a
``collective`` event in the flight recorder, and, with the
``collective`` sanitizer armed, the signature cross-checked across the
processes before the dispatch (utils/sanitizers.note_collective).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.parallel import bootstrap
from oap_mllib_tpu_torch.parallel.mesh import Mesh, Rank
from oap_mllib_tpu_torch.telemetry import flightrec
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.telemetry.spans import current_span
from oap_mllib_tpu_torch.utils import faults, recovery, sanitizers

_CENSUS: collections.Counter = collections.Counter()


def note(op: str, axis: Optional[str] = None) -> None:
    _CENSUS[(op, axis)] += 1


def emitted(op: str, axis: Optional[str] = None) -> int:
    """Collectives ``op`` counted so far (over ``axis``, or any axis when
    None)."""
    return sum(n for (o, a), n in _CENSUS.items()
               if o == op and (axis is None or a == axis))


def reset_census() -> None:
    _CENSUS.clear()


# -- the host exchange between processes -----------------------------------------

# the host side of the cross-process collectives: calls, seconds (the
# host copies and the gloo calls), the seconds inside gloo alone, bytes
# this process sent
HOST_STATS = {"calls": 0, "seconds": 0.0, "gloo_s": 0.0, "bytes": 0}


def reset_host_stats() -> None:
    HOST_STATS.update(calls=0, seconds=0.0, gloo_s=0.0, bytes=0)


def _instrumented(op: str, axis: str, shape, dtype, nbytes: int, dispatch,
                  watched: Optional[str] = None):
    """Run one host dispatch with its telemetry (module docstring): the
    flight-recorder event and the sanitizer's cross-check come before the
    dispatch, so a divergence or a timeout points at this event.  The
    watcher names the dispatch ``watched`` (default ``op``)."""
    if flightrec.enabled():
        flightrec.record("collective", op, f"{axis}|{tuple(shape)}|{sanitizers.dtype_name(dtype)}")
    sanitizers.note_collective(op, axis, shape, dtype)
    t0 = time.perf_counter()
    out = recovery.guarded_dispatch(watched or op, axis, dispatch)
    dt = time.perf_counter() - t0
    lab = {"op": op}
    _tm.counter("oap_collective_ops_total", lab,
                help="Collective facade dispatches by op").inc()
    _tm.counter("oap_collective_bytes_total", lab,
                help="Operand bytes through the collective facade").inc(nbytes)
    _tm.histogram("oap_collective_dispatch_seconds", lab,
                  help="Per-dispatch wall (compile included on first shape)").observe(dt)
    sp = current_span()
    if sp is not None:
        sp.note_collective(op, nbytes, dt)
    return out


def _all_gather_host(local: torch.Tensor, op: str = "all_gather", sig=None) -> torch.Tensor:
    """``(world, *local.shape)``: every process's contiguous host tensor,
    through one gloo ``all_gather`` of its bytes.  Every process passes
    one shape and dtype (its callers' shapes are a function of the mesh
    or of the call), so no size travels first.  ``op`` and ``sig``
    (shape, dtype) name the dispatch for the telemetry (default: the
    tensor's own)."""
    import torch.distributed as dist

    faults.maybe_fault("collective.dispatch")
    world = dist.get_world_size()
    flat = local.reshape(-1).view(torch.uint8)
    out = torch.empty((world, flat.numel()), dtype=torch.uint8)
    shape, dtype = sig if sig is not None else (tuple(local.shape), local.dtype)
    if flat.numel():
        t0 = time.perf_counter()
        _instrumented(op, "host", shape, dtype, flat.numel(),
                      lambda: dist.all_gather(list(out.unbind(0)), flat), watched="all_gather")
        HOST_STATS["gloo_s"] += time.perf_counter() - t0
    HOST_STATS["calls"] += 1
    HOST_STATS["bytes"] += flat.numel()
    return out.view(local.dtype).reshape((world, *local.shape))


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            raise TypeError("a host collective carries no bfloat16 tensor")
        return t.detach().cpu().contiguous().numpy()
    return np.ascontiguousarray(np.asarray(t))


def process_allgather(arrays: Sequence) -> List[np.ndarray]:
    """Each array (host numpy, or a tensor moved to the host) gathered
    from every process along a new leading axis: ``(world, ...)``, the
    same on every process, as the JAX package's ``process_allgather``.
    Every process passes arrays of the same shapes and dtypes; they
    travel as one byte buffer (each array 8-byte aligned in it)."""
    note("process_allgather", "host")
    local = [_host(a) for a in arrays]
    if bootstrap.world_size() == 1:
        return [a[None] for a in local]
    t0 = time.perf_counter()
    offs = np.cumsum([0] + [-(-a.nbytes // 8) * 8 for a in local])
    if len(local) == 1:
        buf = local[0].reshape(-1).view(np.uint8)  # a view: no copy
        if not buf.flags.writeable:  # torch.from_numpy wants a writable array
            buf = buf.copy()
    else:
        buf = np.zeros(int(offs[-1]), np.uint8)
        for a, o in zip(local, offs):
            buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    sig = (tuple(tuple(a.shape) for a in local), ",".join(str(a.dtype) for a in local))
    raw = _all_gather_host(torch.from_numpy(buf), "process_allgather", sig).numpy()
    got = [np.ascontiguousarray(raw[:, o:o + a.nbytes]).view(a.dtype).reshape(
        (raw.shape[0], *a.shape)) for a, o in zip(local, offs)]
    HOST_STATS["seconds"] += time.perf_counter() - t0
    return got


def all_to_all(send: Sequence[np.ndarray], axis: Optional[str] = None) -> List[np.ndarray]:
    """``send[q]`` goes to process ``q``; returns what every process sent
    here, in process order.  Every array of every process has one shape
    and dtype (pad to the largest, as the JAX shuffle pads its buckets):
    one gloo ``all_to_all_single``."""
    import torch.distributed as dist

    note("all_to_all", axis)
    send = [np.ascontiguousarray(a) for a in send]
    world = bootstrap.world_size()
    if len(send) != world:
        raise ValueError(f"all_to_all sends {len(send)} arrays in a world of {world}")
    if world == 1:
        return [send[0].copy()]
    shape, dtype = send[0].shape, send[0].dtype
    if any(a.shape != shape or a.dtype != dtype for a in send):
        raise ValueError("all_to_all: every array must have one shape and dtype")
    faults.maybe_fault("collective.dispatch")
    flat = torch.from_numpy(np.concatenate([a.reshape(-1).view(np.uint8) for a in send]))
    recv = torch.empty_like(flat)
    _instrumented("all_to_all", axis or "host", (world, *shape), dtype, flat.numel(),
                  lambda: dist.all_to_all_single(recv, flat))
    return [np.frombuffer(c.numpy().tobytes(), dtype).reshape(shape)
            for c in recv.chunk(world)]


def barrier() -> None:
    """Every process of the world reaches this point before any leaves
    it (a no-op in one process)."""
    if bootstrap.world_size() > 1:
        import torch.distributed as dist

        _instrumented("barrier", "host", (), "none", 0, dist.barrier)


def agree(error: Optional[BaseException], what: str) -> None:
    """A barrier that carries an error flag: every process reaches it,
    and when any process brings an ``error`` every process raises
    ``RuntimeError`` naming the processes that failed (this process's
    own error chained), so a failure on one process never leaves its
    peers waiting in their next collective.  In one process it raises
    ``error`` itself."""
    if bootstrap.world_size() == 1:
        if error is not None:
            raise error
        return
    import torch.distributed as dist

    # every process sends its flag to every process in one round (an
    # all_gather's ring takes world - 1 rounds, a barrier's cost is one)
    world = bootstrap.world_size()
    flags = torch.empty((world,), dtype=torch.int64)
    mine = torch.full((world,), int(error is not None), dtype=torch.int64)
    _instrumented("agree", "host", (world,), "int64", 8 * world,
                  lambda: dist.all_to_all_single(flags, mine))
    failed = [q for q, f in enumerate(flags.tolist()) if f]
    if failed:
        raise RuntimeError(f"{what} failed on process(es) {failed} "
                           f"(here: {error!r})") from error


def _gather_ranks(parts: Dict[Rank, torch.Tensor], mesh: Mesh, members: Sequence[Rank]
                  ) -> Dict[Rank, torch.Tensor]:
    """Host copies of the parts of every rank in ``members`` (a
    collective: every process calls it with its own members' parts, all
    of one shape and dtype).  Each process copies its members' parts, in
    member order, into one host buffer padded to the largest process's
    count; one gloo all_gather brings in the others'."""
    t0 = time.perf_counter()
    by_proc = [[r for r in members if mesh.process_of(r) == q] for q in range(mesh.processes)]
    if not all(by_proc):
        # a pure function of the mesh and the members: every process raises
        raise ValueError(f"every process must hold a rank of {list(members)}")
    mine = by_proc[mesh.process]
    first = parts[mine[0]]
    if first.dtype == torch.bfloat16:
        raise TypeError("a host collective carries no bfloat16 tensor")
    buf = torch.zeros((max(map(len, by_proc)), *first.shape), dtype=first.dtype)
    for i, r in enumerate(mine):
        buf[i].copy_(parts[r])
    got = _all_gather_host(buf)
    HOST_STATS["seconds"] += time.perf_counter() - t0
    return {r: got[q, i] for q, ranks in enumerate(by_proc) for i, r in enumerate(ranks)}


def _spanning(mesh: Optional[Mesh], groups: Sequence[Sequence[Rank]]) -> bool:
    """Whether any group holds ranks of two processes (a pure function
    of the mesh: every process answers the same)."""
    return mesh is not None and mesh.processes > 1 and any(mesh.spans(g) for g in groups)


def _fold(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc


def _to_devices(value: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``value`` on each device, one copy per distinct device."""
    made = {}
    return [made.setdefault(d, value.to(d)) for d in devices]


# -- psum, all_gather, ppermute ---------------------------------------------------


def psum_group(parts: Sequence[torch.Tensor], axis: Optional[str] = None, *,
               mesh: Optional[Mesh] = None, group: Optional[Sequence[Rank]] = None
               ) -> List[torch.Tensor]:
    """The sum of one group's tensors, added in rank order, on every
    rank's device.  Ranks that share a device share the result tensor;
    a group of one returns its tensor unchanged.  Across processes pass
    the ``mesh`` and the whole ``group``: ``parts`` are then the tensors
    of the group's local ranks, in group order, and so is the result."""
    if group is None or not _spanning(mesh, [group]):
        note("psum", axis)
        return [_fold(list(parts)).to(p.device) for p in parts]
    local = [r for r in group if mesh.is_local(r)]
    return [psum({r: p for r, p in zip(local, parts)}, mesh, axis, [group])[r] for r in local]


def psum(parts: Dict[Rank, torch.Tensor], mesh: Mesh, axis: str,
         groups: Optional[Sequence[Sequence[Rank]]] = None) -> Dict[Rank, torch.Tensor]:
    """``lax.psum`` over ``axis`` of per-rank tensors ``{(i, j): t}`` (the
    local ranks' in a world of several processes): every group along the
    axis (or of ``groups``) that holds a local rank sums in rank order;
    returns the local ranks' sums on their devices."""
    groups = mesh.groups(axis) if groups is None else groups
    host = parts
    if _spanning(mesh, groups):
        host = _gather_ranks(parts, mesh, [r for g in groups for r in g])
    out = {}
    for group in groups:
        local = [r for r in group if r in parts]
        if not local:
            continue
        note("psum", axis)
        acc = _fold([host[r] for r in group])
        for rank, t in zip(local, _to_devices(acc, [parts[r].device for r in local])):
            out[rank] = t
    return out


def psum_many(many: Sequence[Dict[Rank, torch.Tensor]], mesh: Mesh, axis: str
              ) -> List[Dict[Rank, torch.Tensor]]:
    """:func:`psum` of several per-rank dictionaries at once: the same
    sums, the same census (one psum a dictionary a group), and across
    processes one host exchange for all of them, not one each."""
    groups = mesh.groups(axis)
    if not _spanning(mesh, groups):
        return [psum(parts, mesh, axis) for parts in many]
    stacked = {r: torch.cat([parts[r].reshape(-1) for parts in many]) for r in many[0]}
    summed = psum(stacked, mesh, axis)
    for _ in many[1:]:
        for group in groups:
            if any(r in stacked for r in group):
                note("psum", axis)
    out, off = [], 0
    for parts in many:
        r0 = next(iter(parts))
        n, shape = parts[r0].numel(), parts[r0].shape
        out.append({r: t[off:off + n].reshape(shape) for r, t in summed.items()})
        off += n
    return out


def all_gather(parts: Dict[Rank, torch.Tensor], mesh: Mesh, axis: str, dim: int = 0
               ) -> Dict[Rank, torch.Tensor]:
    """``lax.all_gather(..., tiled=True)`` over ``axis``: every local rank
    gets its group's tensors concatenated along ``dim`` in rank order, on
    its device.  Ranks of a group that share a device share the result."""
    groups = mesh.groups(axis)
    host = (_gather_ranks(parts, mesh, [r for g in groups for r in g])
            if _spanning(mesh, groups) else parts)
    out = {}
    for group in groups:
        local = [r for r in group if r in parts]
        if not local:
            continue
        note("all_gather", axis)
        built = {}
        for r in local:
            dev = parts[r].device
            if dev not in built:
                built[dev] = torch.cat([host[q].to(dev) for q in group], dim=dim)
            out[r] = built[dev]
    return out


def all_gather_group(parts: Sequence[torch.Tensor], axis: Optional[str] = None,
                     dim: int = 0, *, mesh: Optional[Mesh] = None,
                     group: Optional[Sequence[Rank]] = None) -> List[torch.Tensor]:
    """One group's tensors concatenated along ``dim`` in rank order, on
    every rank's device; ranks that share a device share the result.
    Across processes: ``mesh`` and the whole ``group``, ``parts`` the
    local ranks' tensors (see :func:`psum_group`)."""
    if group is not None and _spanning(mesh, [group]):
        local = [r for r in group if mesh.is_local(r)]
        host = _gather_ranks(dict(zip(local, parts)), mesh, list(group))
        parts_all = [host[r] for r in group]
        devices = [p.device for p in parts]
    else:
        parts_all, devices = list(parts), [p.device for p in parts]
    note("all_gather", axis)
    built = {}
    out = []
    for dev in devices:
        if dev not in built:
            built[dev] = torch.cat([q.to(dev) for q in parts_all], dim=dim)
        out.append(built[dev])
    return out


def ppermute(parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             axis: Optional[str] = None, *, mesh: Optional[Mesh] = None,
             group: Optional[Sequence[Rank]] = None) -> List[Optional[torch.Tensor]]:
    """``lax.ppermute`` within one group: ``out[dst]`` is a copy of
    ``parts[src]`` on ``dst``'s device for each ``(src, dst)`` of
    ``perm`` (indices into the group); a rank that receives nothing gets
    None.  Across processes: ``mesh`` and the whole ``group``, ``parts``
    and the result the local ranks' (see :func:`psum_group`)."""
    note("ppermute", axis)
    if group is not None and _spanning(mesh, [group]):
        local = [r for r in group if mesh.is_local(r)]
        host = _gather_ranks(dict(zip(local, parts)), mesh, list(group))
        dev = {r: p.device for r, p in zip(local, parts)}
        got = {group[dst]: host[group[src]].to(dev[group[dst]], copy=True)
               for src, dst in perm if group[dst] in dev}
        return [got.get(r) for r in local]
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(parts[dst].device, copy=True)
    return out
