"""Streamed block-parallel ALS: the out-of-core ALS composed with the mesh
(the JAX package's ``ops/als_block_stream.py``).

ops/als_stream.py bounds one card's memory by walking host-resident
grouped layouts through it chunk by chunk; ops/als_block.py spreads the
fit over the ranks of a mesh but keeps every rank's layouts on its
card.  Here each rank keeps its OWN block's grouped layouts in host
memory (the reference's executors hold only their partition,
``OneDAL.scala:92-166``) and streams them through its device every
half-iteration, while the structure between the ranks stays the block
route's:

- **replicated item layout**: the user update is local to each rank;
  for the item update each rank accumulates an (n_items, r+1, r+2)
  moment sheet from its block's edges, its three views (A, b, n_reg)
  and the X-block Grams are psum-ed over the ranks, then every rank
  solves every item (als_block._block_body with streamed sides);
- **2-D item layout**: both factor tables block-sharded; each
  half-iteration all-gathers the other side's blocks once and streams
  this side's chunks against the gathered table (als_block._block_body_2d
  with streamed sides).

Device memory per rank is O(chunk + factors + moments): one chunk of
``als_stream.groups_per_chunk`` groups, this rank's factor block and the
replicated (or gathered) source side, one moment sheet.  Host memory per
process is O(its blocks' padded edges).

The chunks are the in-memory route's blocks of groups (as in
ops/als_stream.py), so where a rank's chunks are its blocks the streamed
fit equals the resident block fit bit for bit: the per-chunk moments,
the segment sums and the psum's rank order are the same.  K3 and K4 run
once a rank a half-iteration, ``2 * world * max_iter`` launches each in
an implicit fit (an explicit fit launches no Gram).

Across processes each process passes its own triples; the port's shuffle
(parallel/shuffle.exchange_ratings, with the weighted ``offsets`` when
given) moves them to the process that holds their block, keeping
source-process order, so the fit does not depend on how the ratings were
split.  The psums and gathers of an iteration then reach the other
processes' ranks (parallel/collective.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.data.prefetch import PrefetchStats
from oap_mllib_tpu_torch.ops import als_block, als_ops, als_stream
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from oap_mllib_tpu_torch.parallel.mesh import Mesh, Rank
from oap_mllib_tpu_torch.utils.timing import tick

# the JAX package's name for the block of each key
_block_of = als_block.block_of


def owned_blocks(mesh: Mesh) -> List[int]:
    """The blocks whose data rank lives in this process (every block in
    one process)."""
    return [b for b, _ in als_block._local_blocks(mesh)]


class StreamedSide:
    """One update direction of one rank: its grouped layout in host
    memory, walked through the device of the factors it is given, ``gc``
    groups a chunk (the in-memory route's block of groups at rank ``r``),
    whenever its moments are asked for."""

    def __init__(self, grouped_host, n_dst: int, r: int, stats: PrefetchStats):
        self.host = tuple(np.ascontiguousarray(a, t) for a, t in
                          zip(grouped_host, (np.int32, np.float32, np.float32, np.int32)))
        self.n_dst = int(n_dst)
        self.stats = stats
        g, p = self.host[0].shape
        self.gc = als_stream.groups_per_chunk(g, p, r) if g else 1
        self.width = als_stream._segments_width(self.host[3], self.gc) if g else 0

    @property
    def groups(self) -> int:
        return self.host[0].shape[0]

    def moments(self, src_factors: torch.Tensor, alpha: float, implicit: bool,
                policy: str = "f32") -> torch.Tensor:
        """The (n_dst, r+1, r+2) moment sheet of this side's edges against
        ``src_factors`` (on this rank's device)."""
        return als_stream.stream_moments(self.host, src_factors, self.n_dst, self.gc, alpha,
                                         implicit, self.stats, policy, self.width)

    def partials(self, src_factors: torch.Tensor, alpha: float, implicit: bool,
                 policy: str = "f32"):
        """``(A, b, n_reg)``: the views of :meth:`moments`, as
        ``GroupedSide.partials`` returns them."""
        return als_stream.sheet_views(self.moments(src_factors, alpha, implicit, policy))


@dataclasses.dataclass
class StreamedBlockLayouts:
    """Each local rank's two streamed sides and the block layout they
    were built for: ``users`` (the user block's edges by local user) and
    ``items`` (by global item in the replicated layout, by local item in
    the 2-D one), the user blocks' ``edges`` (offsets, upb) and, in the
    2-D layout, the item blocks' ``by_item``."""

    sides: als_block.BlockSides
    edges: als_block.BlockEdges
    by_item: Optional[als_block.BlockEdges]
    item_sharded: bool
    stats: PrefetchStats

    @property
    def offsets_u(self) -> np.ndarray:
        return self.edges.offsets

    @property
    def upb(self) -> int:
        return self.edges.upb


def prepare_streamed_block_layouts(users, items, ratings, n_users: int, n_items: int,
                                   mesh: Mesh, r: int, *, item_sharded: bool,
                                   sizes: Optional[tuple] = None,
                                   offsets=None) -> StreamedBlockLayouts:
    """The host-resident grouped layouts of the streamed block fit.

    The triples are this process's; the shuffle by user block (and, in
    the 2-D layout, a second one by item block) gives each local rank
    its block's edges, and each gets the two grouped layouts the resident
    block route builds (als_block.prepare_grouped_inputs / ``_2d``), kept
    in host memory.  ``sizes`` is the grouped guard's ``(p_u, p_i, nnz)``
    when it ran (else the group sizes come from the world's counts here).
    ``offsets`` are capability-weighted user-block boundaries
    (parallel/balance.block_offsets), the replicated layout only: the 2-D
    layout's gathers need uniform blocks."""
    world = mesh.shape[mesh.axis_names[0]]
    if offsets is not None and item_sharded:
        raise ValueError("weighted block offsets require the replicated-item layout "
                         "(the 2-D layout's gathers need uniform blocks)")
    edges = als_block.prepare_block_inputs(users, items, ratings, world, n_users, mesh,
                                           offsets=offsets)
    by_item = None
    if item_sharded:
        by_item = als_block.prepare_block_inputs(items, users, ratings, world, n_items, mesh)
        p_u, p_i = (sizes[0], sizes[1]) if sizes is not None else als_block._group_sizes_2d(
            edges.nnz, world, edges.upb, by_item.upb)
    else:
        p_u, p_i = (sizes[0], sizes[1]) if sizes is not None else als_block._group_sizes(
            edges.nnz, world, edges.upb, n_items)
    stats = PrefetchStats()
    users_s: Dict[Rank, StreamedSide] = {}
    items_s: Dict[Rank, StreamedSide] = {}
    for b, q in als_block._local_blocks(mesh):
        u, i, rt = edges.users[b], edges.items[b], edges.ratings[b]
        users_s[q] = StreamedSide(als_ops.build_grouped_edges(u, i, rt, edges.upb, p_u),
                                  edges.upb, r, stats)
        if item_sharded:
            items_s[q] = StreamedSide(
                als_ops.build_grouped_edges(by_item.users[b], by_item.items[b],
                                            by_item.ratings[b], by_item.upb, p_i),
                by_item.upb, r, stats)
        else:
            items_s[q] = StreamedSide(als_ops.build_grouped_edges(i, u, rt, n_items, p_i),
                                      n_items, r, stats)
    return StreamedBlockLayouts(
        sides=als_block._sides(users_s, items_s, True, mesh), edges=edges, by_item=by_item,
        item_sharded=item_sharded, stats=stats)


def als_block_run_streamed(lay: StreamedBlockLayouts, x0: Dict[Rank, torch.Tensor],
                           y0: Dict[Rank, torch.Tensor], max_iter: int, reg: float,
                           alpha: float, mesh: Mesh, *, implicit: bool, timings=None,
                           policy: str = "f32",
                           solve: Callable = als_kernel.solve_normal_eq,
                           gram: Callable = als_kernel.factor_gram, checkpoint=None
                           ) -> Tuple[Dict[Rank, torch.Tensor], Dict[Rank, torch.Tensor]]:
    """The streamed block ALS (both feedback modes, both item layouts):
    ``(x blocks, y)`` in the resident runners' forms (y the replicated
    copies, or the item blocks of the 2-D layout).  ``x0[q]`` is rank
    ``q``'s (upb, r) user block, ``y0[q]`` its (n_items, r) copy or (ipb,
    r) item block.  Every chunk's stage / transfer / compute split lands
    in ``timings`` under ``als_iterations/``.  ``solve`` and ``gram``
    are the kernel wrappers; the card check passes their plain
    versions.

    ``checkpoint`` (utils/checkpoint.py): every process writes its
    blocks' valid rows every ``checkpoint_interval`` iterations, and a
    restore redistributes what the relaunched world read onto the live
    blocks (als_block.restore_block_factors), whether the world shrank,
    grew or only re-blocked."""
    body = als_block._block_body_2d if lay.item_sharded else als_block._block_body
    elapsed = tick()
    args = (reg, alpha if implicit else 0.0, implicit, mesh.axis_names[0], policy, solve,
            gram, body)
    if checkpoint is None:
        x, y = als_block._run(lay.sides, x0, y0, max_iter, *args)
    else:
        layout = als_block.block_ckpt_layout(
            lay.offsets_u, lay.upb, lay.item_sharded,
            lay.by_item.offsets if lay.item_sharded else None,
            lay.by_item.upb if lay.item_sharded else None)
        n_items = next(iter(y0.values())).shape[0]
        start, x, y = als_block.restore_block_factors(checkpoint, mesh, layout, n_items,
                                                      max_iter, x0, y0)
        for it in range(start, max_iter):
            x, y = als_block._run(lay.sides, x, y, 1, *args)
            if checkpoint.due(it + 1):
                als_block.write_block_factors(checkpoint, it + 1, x, y, mesh, layout)
    for t in list(x.values()) + list(y.values()):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
    lay.stats.finalize(timings, "als_iterations", elapsed())
    return x, y
