"""Streamed ALS: the grouped edge layouts stay in host memory and walk
through the card in fixed-size group chunks every half-iteration (the
JAX package's ``ops/als_stream.py``).

The in-memory grouped route keeps both layouts on the card for the whole
fit (~12 bytes a padded edge a side).  Here only the factors and one
moment sheet stay there: each half-iteration stages the destination
side's layout chunk by chunk through the prefetch pipeline (pinned host
buffers, copies on a side stream, data/prefetch.py), so chunk N+1's
copy overlaps chunk N's moments.  Peak device memory is O(chunk +
factors + moments):

- chunk: ``groups_per_chunk(G, P, r)`` groups of the grouped arrays,
  the in-memory moments' block of groups;
- factors: (n_users + n_items) x r;
- moments: one (n_dst, r+1, r+2) sheet whose views are A, b and n_reg.

Per chunk the moments are ``als_ops.grouped_block_moments`` (the copy-
free batched products of the in-memory route), segment-summed by
destination into the sheet's views in chunk order.  Then the solve is
the solve kernel (K3) through ``als_ops.regularized_solve``, with the
implicit Gram from the factor-Gram kernel (K4) through
``als_ops._factor_gram``: K3 and K4 launch twice an iteration, as in
memory.  The chunks are the in-memory route's blocks of groups, so
each chunk's products and segment sums are the in-memory route's and
the streamed factors equal the in-memory ones bit for bit.  The last
chunk stages padded to the full width (padding groups carry valid 0 and
the last destination) and computes on its real groups only, so every
chunk copies one shape and the pinned buffers are made once.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.data.prefetch import Prefetcher, PrefetchStats
from oap_mllib_tpu_torch.ops import als_ops
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from oap_mllib_tpu_torch.utils import progcache
from oap_mllib_tpu_torch.utils.dispatch import resolve_device
from oap_mllib_tpu_torch.utils.resilience import check_finite
from oap_mllib_tpu_torch.utils.timing import tick


def groups_per_chunk(g: int, p: int, r: int) -> int:
    """Groups per staged chunk of a side of ``g`` groups of ``p`` edges:
    the in-memory route's block of groups (``als_ops._grouped_block_count``,
    the JAX package's live-buffer charge: 128-lane padding and ~3 live
    (r+2)-deep intermediates).  The JAX package rounds its chunk down from
    the same budget instead; taking the in-memory blocks as the chunks
    makes every chunk's products and segment sums the in-memory route's,
    so the streamed fit equals it bit for bit."""
    return max(1, -(-g // als_ops._grouped_block_count(g, p, r)))


def _pad_group_rows(grouped, multiple: int, n_dst: int):
    """A grouped layout (a side, or one chunk of it) padded to a multiple
    of ``multiple`` groups: padding groups carry valid 0 and destination
    ``n_dst - 1``, which keeps ``group_dst`` sorted."""
    src_g, conf_g, valid_g, gdst = grouped
    g, p = src_g.shape
    pad = (-g) % multiple
    if pad:
        src_g = np.concatenate([src_g, np.zeros((pad, p), np.int32)])
        conf_g = np.concatenate([conf_g, np.zeros((pad, p), np.float32)])
        valid_g = np.concatenate([valid_g, np.zeros((pad, p), np.float32)])
        gdst = np.concatenate([gdst, np.full((pad,), n_dst - 1, np.int32)])
    return (np.ascontiguousarray(src_g, np.int32), np.ascontiguousarray(conf_g, np.float32),
            np.ascontiguousarray(valid_g, np.float32), np.ascontiguousarray(gdst, np.int32))


def _segments_width(gdst: np.ndarray, gc: int) -> int:
    """The most destinations one chunk of ``gc`` groups spans."""
    lo = np.arange(0, len(gdst), gc)
    hi = np.minimum(lo + gc, len(gdst)) - 1
    return int(np.max(gdst[hi] - gdst[lo])) + 1


def _stage_group_chunk(grouped_host, gc: int, width: int, n_dst: int):
    """The producer's stage of the chunk of groups at ``lo``: the three
    host slices to copy (the last chunk padded to ``gc`` groups) and the
    chunk's segment lengths by destination (padded to ``width``), so
    every chunk copies one shape into the same pinned buffers; the
    chunk's first destination, segment count and real group count ride
    along."""
    src_g, conf_g, valid_g, gdst = grouped_host

    def stage(lo):
        hi = min(lo + gc, len(gdst))
        pieces = (src_g[lo:hi], conf_g[lo:hi], valid_g[lo:hi], gdst[lo:hi])
        if hi - lo < gc:
            pieces = _pad_group_rows(pieces, gc, n_dst)
        first = int(gdst[lo])
        counts = np.bincount(gdst[lo:hi] - first)
        lengths = np.zeros((width,), np.int64)
        lengths[:len(counts)] = counts
        return ((first, len(counts), hi - lo),
                tuple(torch.from_numpy(a) for a in (*pieces[:3], lengths)))

    return stage


def _accum_moments(views, src_c, conf_c, valid_c, lengths, first: int,
                   factors: torch.Tensor, alpha: float, implicit: bool, policy: str) -> None:
    """Add one chunk's per-group moments into the sheet's views (A, b,
    n_reg) by destination (``lengths`` the chunk's segment lengths from
    destination ``first`` on)."""
    moments = als_ops.grouped_block_moments(src_c, conf_c, valid_c, factors, alpha, implicit,
                                            policy)
    for out, rows in zip(views, moments):
        als_ops._segment_add(out, rows, first, lengths)


def sheet_views(m: torch.Tensor):
    """``(A, b, n_reg)``: the views of an (n_dst, r+1, r+2) moment sheet."""
    r = m.shape[1] - 1
    return m[:, :r, :r], m[:, :r, r], m[:, r, r + 1]


def stream_moments(grouped_host, factors: torch.Tensor, n_dst: int, gc: int, alpha: float,
                   implicit: bool, stats: Optional[PrefetchStats] = None,
                   policy: str = "f32", width: Optional[int] = None) -> torch.Tensor:
    """One side's (n_dst, r+1, r+2) moment sheet on the device of
    ``factors``: the host layout walked through the device chunk by
    chunk, ``gc`` groups a chunk, each chunk's moments added into the
    sheet's views by destination (``width``: the most destinations a
    chunk spans, :func:`_segments_width`, found here when None)."""
    r = factors.shape[1]
    m = torch.zeros((n_dst, r + 1, r + 2), dtype=torch.float32, device=factors.device)
    if grouped_host[0].shape[0] == 0:
        return m
    views = sheet_views(m)
    width = _segments_width(grouped_host[3], gc) if width is None else width
    with Prefetcher(range(0, grouped_host[0].shape[0], gc),
                    stage=_stage_group_chunk(grouped_host, gc, width, n_dst),
                    device=factors.device, stats=stats) as pf:
        for (first, n_seg, ng), (src_c, conf_c, valid_c, lengths) in pf:
            _accum_moments(views, src_c[:ng], conf_c[:ng], valid_c[:ng], lengths[:n_seg],
                           first, factors, alpha, implicit, policy)
    return m


def _half_update_streamed(grouped_host, factors: torch.Tensor, n_dst: int, gc: int,
                          reg: float, alpha: float, implicit: bool,
                          stats: Optional[PrefetchStats] = None, policy: str = "f32",
                          solve: Callable = als_kernel.solve_normal_eq,
                          gram: Callable = als_kernel.factor_gram) -> torch.Tensor:
    """One side's update: :func:`stream_moments`, then the solve.  Returns
    the (n_dst, r) factors on the device of ``factors``."""
    m = stream_moments(grouped_host, factors, n_dst, gc, alpha, implicit, stats, policy)
    g = als_ops._factor_gram(factors, gram) if implicit else None
    return als_ops.regularized_solve(*sheet_views(m), reg, g, solve)


def als_run_streamed(by_user, by_item, x0, y0, n_users: int, n_items: int, max_iter: int,
                     reg: float, alpha: float, implicit: bool, timings=None,
                     policy: str = "f32", device=None,
                     solve: Optional[Callable] = None,
                     gram: Optional[Callable] = None,
                     degraded: bool = False, checkpoint=None,
                     grown_fill: Optional[Callable] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The streamed ALS loop (both feedback modes): ``by_user`` and
    ``by_item`` are host grouped layouts (``als_ops.build_grouped_edges``),
    the factors stay on ``device`` (None: ``Config.device``) across
    iterations, each half-update
    streams its side's layout.  The prefetch split of every chunk lands
    in ``timings`` under ``als_iterations/``.  Returns the host (x, y).
    ``solve`` and ``gram`` are the kernel wrappers (None: K3 and K4 at
    the autotuner's geometry, ``als_ops.tuned_kernels``); the card check
    passes their plain versions.  ``degraded`` is the resilience
    ladder's halving rung: half the groups a chunk, half the device
    memory a step (the segment sums then add in another order, so the
    factors move by rounding only).  Each iteration is the
    ``fit.execute`` fault site, and both factor tables are checked
    finite after it (``NonFiniteError`` naming them).

    ``checkpoint`` (utils/checkpoint.py) restores both tables and the
    iteration at entry (a block world's sharded checkpoint too: this
    process reads every old shard; ``grown_fill(grown, x, y)`` seeds a
    grown id space's tail) and writes them every
    ``checkpoint_interval`` iterations; the iterates are the whole
    state, so a resume is bit-equal (the chunking is outside the
    signature, so a halved re-chunk resumes too)."""
    dev = resolve_device(device)
    r = np.asarray(x0).shape[1]
    solve, gram = als_ops.tuned_kernels(r, implicit, dev, solve, gram)
    if not implicit:
        alpha = 0.0
    by_user, by_item = (tuple(np.ascontiguousarray(a, t) for a, t in
                              zip(side, (np.int32, np.float32, np.float32, np.int32)))
                        for side in (by_user, by_item))
    gc_u = groups_per_chunk(*by_user[0].shape, r)
    gc_i = groups_per_chunk(*by_item[0].shape, r)
    if degraded:
        gc_u, gc_i = max(1, gc_u // 2), max(1, gc_i // 2)
    start_it = 0
    if checkpoint is not None:
        from oap_mllib_tpu_torch.utils import checkpoint as ckpt_mod

        resume = checkpoint.restore()
        if resume.found:
            x0 = ckpt_mod.factors_from_result(resume, "x", n_users)
            y0 = ckpt_mod.factors_from_result(resume, "y", n_items)
            if resume.grown and grown_fill is not None:
                x0, y0 = grown_fill(resume.grown, x0, y0)
            start_it = min(int(resume.step), max_iter)
            if "x" not in resume.arrays:
                checkpoint.mark_resharded()  # sharded state onto one device
    x = torch.as_tensor(np.asarray(x0, np.float32)).to(dev)
    y = torch.as_tensor(np.asarray(y0, np.float32)).to(dev)
    stats = PrefetchStats()
    elapsed = tick()
    key = (progcache.array_key(x, y), implicit, policy)
    for it in range(start_it, max_iter):
        progcache.count_launch("als.iteration_streamed", key)
        x = _half_update_streamed(by_user, y, n_users, gc_u, reg, alpha, implicit, stats,
                                  policy, solve, gram)
        y = _half_update_streamed(by_item, x, n_items, gc_i, reg, alpha, implicit, stats,
                                  policy, solve, gram)
        # a singular solve's NaN factors spread to every later
        # half-update: stop at the iteration that made them
        check_finite(x, f"ALS user factors (streamed iteration {it + 1})")
        check_finite(y, f"ALS item factors (streamed iteration {it + 1})")
        if checkpoint is not None:
            checkpoint.maybe_write(it + 1, {"x": x, "y": y})
    x, y = x.cpu().numpy(), y.cpu().numpy()
    stats.finalize(timings, "als_iterations", elapsed())
    return x, y
