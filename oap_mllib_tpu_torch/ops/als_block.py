"""Block-parallel ALS on a device mesh: the port of the JAX package's
``ops/als_block.py`` (its replicated item layout).

The ratings are partitioned by USER BLOCK over the mesh's data axis:
block ``b`` holds the users ``[offsets[b], offsets[b + 1])``, uniform
blocks of ``ceil(n_users / world)`` ids (or, with several processes of
unequal capability, the uneven blocks parallel/balance.block_offsets
plans), with user ids LOCAL to the block and item ids global
(:func:`exchange_ratings`, the in-process counterpart of the JAX
package's ``parallel/shuffle.exchange_ratings``).
Rank ``b`` holds its block's user factors, ``upb`` rows of which those
past the block's last user are padding (zero, as they have no ratings),
and a replicated copy of the item factors.  One iteration
(:func:`_block_body`, the JAX package's):

- the user update is local: each rank solves its users from its edges
  and its copy of Y, with Y's Gram for implicit feedback;
- the item update: each rank forms the item partials (A, b, n_reg) of
  every item from its edges, the partials and the ranks' X-block Grams
  are psum-ed over the data axis (four sums, in rank order), and every
  rank solves every item.

The 2-D item layout (``als_item_layout="sharded"``, or "auto" past
:data:`ITEM_SHARD_AUTO_BYTES`; :func:`_block_body_2d`, the JAX
package's) shards the item factors too: the ratings are partitioned a
second time, by ITEM block (the same exchange with the roles swapped),
and rank ``b`` holds block ``b`` of both factor tables.  One iteration:

- the item blocks are all-gathered over the data axis (concatenated in
  rank order, so the gathered table is the padded global layout: with
  uniform blocks, global item ``g`` sits at row ``g``); each rank forms
  the moments of its users from its user-block edges and that table,
  and solves them with the psum of the ranks' Y-block Grams;
- the same with the roles swapped: the user blocks all-gathered, each
  rank's item-block edges, the psum of the X-block Grams.

Padding rows of either table are zero (no ratings, so the solve zeroes
them), so the psum of block Grams is the exact Gram.  Per iteration:
two all_gathers and, for implicit feedback, two psums.

Each rank runs the solve (K3) and factor-Gram (K4) kernels on its own
card, so an implicit fit launches each ``2 * world * max_iter`` times
in either layout (an explicit one no Gram).  The JAX package runs a
model axis above 1 as replicas of the data ranks; the port runs the
data ranks of the mesh's first model column.

Across processes (a mesh whose data ranks span them, parallel/mesh.py)
each process passes its own triples; the shuffle moves them to the
processes that hold their blocks (parallel/shuffle.exchange_ratings,
one all_to_all), the grouped-vs-COO guard and the group sizes price the
world's counts (:func:`_global_sum`), each process stages and runs its
own ranks, and the psums and all_gathers of an iteration reach the
other processes' ranks.  :func:`gather_user_factors` is then a
collective every process calls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.ops import als_ops
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from oap_mllib_tpu_torch.parallel import collective, shuffle
from oap_mllib_tpu_torch.parallel.mesh import Mesh, Rank
from oap_mllib_tpu_torch.utils import faults

# "auto" shards the items once the replicated layout's per-iteration psum
# payload (n_items * r * (r + 1) * 4 bytes) crosses this (the JAX
# package's crossover; ML-25M at r = 10 is ~26 MB: replicated)
ITEM_SHARD_AUTO_BYTES = 1 << 27


def als_item_layout_cfg() -> str:
    """Validated ``Config.als_item_layout``; every ALS fit reads it, so a
    typo raises on one device too."""
    layout = get_config().als_item_layout
    if layout not in ("auto", "replicated", "sharded"):
        raise ValueError(f"als_item_layout must be auto|replicated|sharded, got {layout!r}")
    return layout


def item_layout_sharded(n_items: int, r: int, world: int, n_users: int = 0) -> bool:
    """Whether the item factors shard (the 2-D layout): as configured, or
    under "auto" when the replicated psum payload crosses
    :data:`ITEM_SHARD_AUTO_BYTES` and the sharded layout moves fewer
    bytes (``n_users <= n_items (2r + 1)``)."""
    layout = als_item_layout_cfg()
    if layout != "auto":
        return layout == "sharded"
    return (world > 1 and n_items * r * (r + 1) * 4 > ITEM_SHARD_AUTO_BYTES
            and n_users <= n_items * (2 * r + 1))


def data_ranks(mesh: Mesh) -> List[Rank]:
    """The ranks that hold user blocks: the data axis of the first model
    column, in block order."""
    return mesh.groups(mesh.axis_names[0])[0]


def _cross(mesh: Optional[Mesh]) -> bool:
    """Whether the block ranks of ``mesh`` lie in several processes."""
    return mesh is not None and mesh.spans(data_ranks(mesh))


def _global_sum(arr, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Elementwise int64 sum of a host array across the processes (the
    identity in one): every cross-process count of this module."""
    arr = np.asarray(arr, np.int64)
    if not _cross(mesh):
        return arr
    return collective.process_allgather([arr])[0].sum(axis=0)


def _global_max(arr, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Elementwise int64 max across the processes (the identity in one)."""
    arr = np.asarray(arr, np.int64)
    if not _cross(mesh):
        return arr
    return collective.process_allgather([arr])[0].max(axis=0)


# -- the shuffle ---------------------------------------------------------------


@dataclasses.dataclass
class BlockEdges:
    """Ratings partitioned by user block: per block, local user ids,
    global item ids and ratings (numpy), with the block boundaries and
    the user rows per block."""

    users: List[Optional[np.ndarray]]  # None for a block of another process
    items: List[Optional[np.ndarray]]
    ratings: List[Optional[np.ndarray]]
    offsets: np.ndarray  # (world + 1,) global user-id boundaries
    upb: int  # user rows per block, padding included
    nnz: int = 0  # the world's ratings


def block_offsets_of(world: int, n_users: int, offsets=None):
    """``(offsets, weighted)``: the ``(world + 1,)`` user-block boundaries,
    the uniform ``min(b * ceil(n_users / world), n_users)`` when
    ``offsets`` is None, else the given capability-weighted ones
    (parallel/balance.block_offsets), checked to hold ``world`` blocks
    that end at ``n_users``."""
    if offsets is None:
        kpb = max(1, -(-n_users // world))
        return np.minimum(np.arange(world + 1) * kpb, n_users), False
    offsets = np.asarray(offsets, np.int64)
    if len(offsets) != world + 1 or int(offsets[-1]) != n_users:
        raise ValueError(f"offsets must be (world+1,)={world + 1} entries ending at "
                         f"n_users={n_users}, got {offsets!r}")
    return offsets, True


def block_of(keys: np.ndarray, kpb: int, world: int, offsets=None) -> np.ndarray:
    """The block of each key (the JAX package's
    ``als_block_stream._block_of``): ``min(k // kpb, world - 1)`` on the
    uniform layout, and with weighted ``offsets`` the block whose range
    holds it, ``searchsorted(offsets[1:], k, "right")`` clipped to
    ``world - 1``."""
    if offsets is None:
        return np.minimum(keys // kpb, world - 1)
    return np.minimum(np.searchsorted(np.asarray(offsets)[1:], keys, side="right"), world - 1)


def exchange_ratings(users, items, ratings, world: int, n_users: int, offsets=None):
    """Partition the triples by user block: ``(blocks, offsets)`` where
    ``blocks[b]`` is ``(users, items, ratings)`` of the ratings whose
    user lies in block ``b`` (global user ids, input order kept), and
    ``offsets`` the block boundaries: the uniform ``min(b * ceil(n_users
    / world), n_users)``, edges routed to block ``min(u // kpb, world -
    1)`` as in the JAX package, or the given weighted ``offsets``
    (:func:`block_of`)."""
    users, items = np.asarray(users, np.int64), np.asarray(items, np.int64)
    if n_users >= 2 ** 31 or (len(items) and int(np.max(items)) >= 2 ** 31):
        raise ValueError("ids must fit int32 (the device index dtype)")
    offsets, weighted = block_offsets_of(world, n_users, offsets)
    block = block_of(users, max(1, -(-n_users // world)), world, offsets if weighted else None)
    # a stable partition by block: numpy sorts 16-bit keys by radix, O(nnz)
    key = block.astype(np.int16 if world < 2 ** 15 else np.int64)
    order = np.argsort(key, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(block, minlength=world))])
    u, i, r = users[order], items[order], np.asarray(ratings, np.float32)[order]
    blocks = [(u[bounds[b]:bounds[b + 1]], i[bounds[b]:bounds[b + 1]], r[bounds[b]:bounds[b + 1]])
              for b in range(world)]
    return blocks, offsets


def prepare_block_inputs(users, items, ratings, world: int, n_users: int,
                         mesh: Optional[Mesh] = None, offsets=None) -> BlockEdges:
    """The shuffled block layout: user ids rebased to their block
    (``id - offsets[b]``), ``upb`` the widest block (``n_users`` on one
    block).  ``offsets`` are capability-weighted block boundaries
    (parallel/balance.block_offsets; the replicated item layout only),
    None the uniform split.  With a ``mesh`` whose block ranks span
    processes the triples are this process's and the shuffle crosses
    the processes (parallel/shuffle.exchange_ratings, a collective); the
    other processes' blocks are None."""
    if _cross(mesh):
        held, offsets = shuffle.exchange_ratings(users, items, ratings, mesh,
                                                 data_ranks(mesh), n_users, offsets=offsets)
        blocks = [held.get(b) for b in range(world)]
        nnz = int(_global_sum([len(users)], mesh)[0])
    else:
        blocks, offsets = exchange_ratings(users, items, ratings, world, n_users, offsets)
        nnz = len(users)
    upb = int(np.max(np.diff(offsets))) if world > 1 else n_users
    return BlockEdges(
        users=[None if blk is None else blk[0] - offsets[b] for b, blk in enumerate(blocks)],
        items=[None if blk is None else blk[1] for blk in blocks],
        ratings=[None if blk is None else blk[2] for blk in blocks],
        offsets=offsets, upb=max(upb, 1), nnz=nnz,
    )


def _local_blocks(mesh: Mesh):
    """``(block, rank)`` of the block ranks this process holds."""
    return [(b, q) for b, q in enumerate(data_ranks(mesh)) if mesh.is_local(q)]


# -- the grouped-vs-COO guard ---------------------------------------------------


def _group_sizes(nnz_global: int, world: int, users_per_block: int, n_items: int):
    """(p_u, p_i): one derivation for the guard and the build."""
    p_u = als_ops.auto_group_size(max(1, nnz_global), world * users_per_block)
    p_i = als_ops.auto_group_size(max(1, nnz_global // world), n_items)
    return p_u, p_i


def _side_padded_per_block(ids: np.ndarray, kpb: int, world: int, p: int, n_ids: int,
                           mesh: Optional[Mesh] = None):
    """(world,) padded edge totals of one grouped side whose ids are
    partitioned contiguously by ``kpb``: each block sums its ids'
    ceil-paddings (per-id counts by bincount, where the JAX package
    sorts with ``np.unique``; ids without edges pad to zero either
    way), the counts the world's."""
    counts = _global_sum(np.bincount(np.asarray(ids, np.int64), minlength=n_ids), mesh)
    out = np.zeros((world,), np.int64)
    np.add.at(out, np.minimum(np.arange(len(counts)) // kpb, world - 1),
              -(counts // -p) * p)
    return out


def _group_sizes_2d(nnz_global: int, world: int, upb: int, ipb: int):
    """(p_u, p_i) of the 2-D layout: every destination's edges lie on one
    rank on both sides, so both size from the global mean degree."""
    p_u = als_ops.auto_group_size(max(1, nnz_global), world * upb)
    p_i = als_ops.auto_group_size(max(1, nnz_global), world * ipb)
    return p_u, p_i


def block_grouped_guard_2d(users, items, n_users: int, n_items: int, world: int,
                           max_blowup: float = als_ops.GROUPED_MAX_BLOWUP,
                           mesh: Optional[Mesh] = None):
    """The 2-D layout's grouped-vs-COO decision, before the shuffles:
    ``(use_grouped, (p_u, p_i, nnz))``.  Both sides are partitioned by
    id, so each realises ``world * max_b (block's padded total)``.
    Across processes (``mesh``) the triples are this process's and the
    counts the world's."""
    nnz = int(_global_sum([len(users)], mesh)[0])
    kpb_u = max(1, -(-n_users // world))
    kpb_i = max(1, -(-n_items // world))
    p_u, p_i = _group_sizes_2d(nnz, world, kpb_u, kpb_i)
    pu_b = _side_padded_per_block(users, kpb_u, world, p_u, n_users, mesh)
    pi_b = _side_padded_per_block(items, kpb_i, world, p_i, n_items, mesh)
    total = world * (int(pu_b.max()) + int(pi_b.max()))
    return total <= max_blowup * max(nnz, 1), (p_u, p_i, nnz)


def block_grouped_guard(users, items, n_users: int, n_items: int, world: int,
                        max_blowup: float = als_ops.GROUPED_MAX_BLOWUP,
                        mesh: Optional[Mesh] = None):
    """The block route's grouped-vs-COO decision, before the shuffle:
    ``(use_grouped, (p_u, p_i, nnz))``.  Priced as the JAX package prices
    what its build realizes, every rank padded to the largest block:
    ``world * (max_b padded_u_b + max_b padded_i_b)`` against
    ``max_blowup * nnz``.  The user side pads per user; the item side
    per (block, item) pair, since an item's edges split over blocks.
    Across processes (``mesh``) the triples are this process's and the
    counts the world's."""
    nnz = int(_global_sum([len(users)], mesh)[0])
    kpb = max(1, -(-n_users // world))
    p_u, p_i = _group_sizes(nnz, world, kpb, n_items)
    u = np.asarray(users, np.int64)
    pu_b = _side_padded_per_block(u, kpb, world, p_u, n_users, mesh)
    block = np.minimum(u // kpb, world - 1)
    pair = _global_sum(np.bincount(block * n_items + np.asarray(items, np.int64),
                                   minlength=world * n_items), mesh).reshape(world, n_items)
    pi_b = (-(pair // -p_i) * p_i).sum(axis=1)
    total = world * (int(pu_b.max()) + int(pi_b.max()))
    return total <= max_blowup * max(nnz, 1), (p_u, p_i, nnz)


# -- staging ---------------------------------------------------------------------


@dataclasses.dataclass
class BlockSides:
    """Per data rank, both update directions staged on its device:
    ``users[q]`` by local user (``upb`` destinations), ``items[q]`` by
    global item (``n_items``) in the replicated layout, by local item
    (``ipb``) in the 2-D one; grouped or COO."""

    users: Dict[Rank, object]
    items: Dict[Rank, object]
    grouped: bool
    # the mesh and its block ranks, when they span processes (the
    # collectives then reach the other processes' ranks)
    mesh: Optional[Mesh] = None
    group: Optional[List[Rank]] = None


def prepare_grouped_inputs(edges: BlockEdges, mesh: Mesh, n_items: int, rank: int,
                           sizes: Optional[tuple] = None) -> BlockSides:
    """Each block's grouped layouts, built on the host (the counting sort
    of ops/host_prep.py) with the guard's group sizes, and staged on its
    rank's device.  The JAX package pads every rank to the largest group
    count for its static shapes; the eager port does not need to."""
    world = len(edges.users)
    if sizes is not None:
        p_u, p_i = sizes[0], sizes[1]
    else:
        p_u, p_i = _group_sizes(edges.nnz, world, edges.upb, n_items)
    users, items = {}, {}
    for b, q in _local_blocks(mesh):
        dev = mesh.device(q)
        u, i, r = edges.users[b], edges.items[b], edges.ratings[b]
        users[q] = als_ops.prepare_grouped(
            *als_ops.build_grouped_edges(u, i, r, edges.upb, p_u), edges.upb, rank, dev)
        items[q] = als_ops.prepare_grouped(
            *als_ops.build_grouped_edges(i, u, r, n_items, p_i), n_items, rank, dev)
    return _sides(users, items, True, mesh)


def _sides(users, items, grouped: bool, mesh: Mesh) -> BlockSides:
    cross = _cross(mesh)
    return BlockSides(users, items, grouped, mesh if cross else None,
                      data_ranks(mesh) if cross else None)


def prepare_coo_inputs(edges: BlockEdges, mesh: Mesh, n_items: int, rank: int) -> BlockSides:
    """Each block's COO sides staged on its rank's device."""
    users, items = {}, {}
    for b, q in _local_blocks(mesh):
        dev = mesh.device(q)
        u, i, r = edges.users[b], edges.items[b], edges.ratings[b]
        valid = np.ones(len(u), np.float32)
        users[q] = als_ops.prepare_coo(u, i, r, valid, edges.upb, rank, dev)
        items[q] = als_ops.prepare_coo(i, u, r, valid, n_items, rank, dev)
    return _sides(users, items, False, mesh)


def prepare_grouped_inputs_2d(by_user: BlockEdges, by_item: BlockEdges, mesh: Mesh,
                              rank: int, sizes: Optional[tuple] = None) -> BlockSides:
    """The 2-D layout's grouped sides: ``users[q]`` groups rank ``q``'s
    user-block edges by local user (sources: global item ids, rows of
    the gathered Y), ``items[q]`` its item-block edges by local item
    (sources: global user ids, rows of the gathered X).  ``by_item`` is
    :func:`prepare_block_inputs` of ``(items, users, ratings)``: its
    ``users`` hold local item ids and its ``items`` global user ids."""
    world = len(by_user.users)
    if sizes is not None:
        p_u, p_i = sizes[0], sizes[1]
    else:
        p_u, p_i = _group_sizes_2d(by_user.nnz, world, by_user.upb, by_item.upb)
    users, items = {}, {}
    for b, q in _local_blocks(mesh):
        dev = mesh.device(q)
        users[q] = als_ops.prepare_grouped(
            *als_ops.build_grouped_edges(by_user.users[b], by_user.items[b], by_user.ratings[b],
                                         by_user.upb, p_u), by_user.upb, rank, dev)
        items[q] = als_ops.prepare_grouped(
            *als_ops.build_grouped_edges(by_item.users[b], by_item.items[b], by_item.ratings[b],
                                         by_item.upb, p_i), by_item.upb, rank, dev)
    return _sides(users, items, True, mesh)


def prepare_coo_inputs_2d(by_user: BlockEdges, by_item: BlockEdges, mesh: Mesh,
                          rank: int) -> BlockSides:
    """The 2-D layout's COO sides (see :func:`prepare_grouped_inputs_2d`)."""
    users, items = {}, {}
    for b, q in _local_blocks(mesh):
        dev = mesh.device(q)
        for out, e in ((users, by_user), (items, by_item)):
            valid = np.ones(len(e.users[b]), np.float32)
            out[q] = als_ops.prepare_coo(e.users[b], e.items[b], e.ratings[b], valid, e.upb,
                                         rank, dev)
    return _sides(users, items, False, mesh)


# -- the iteration -----------------------------------------------------------------


def _block_body(sides: BlockSides, x: Dict[Rank, torch.Tensor], y: Dict[Rank, torch.Tensor],
                reg: float, alpha: float, implicit: bool, axis: str, policy: str,
                solve: Callable, gram: Callable):
    """One alternating iteration on resident or streamed sides: the user
    update local to each rank, then the item partials and the X-block
    Grams psum-ed over ``axis`` and the item update on every rank.  The
    partials psum as three sums, not as one (n_items, r+1, r+2) moment
    sheet: across processes the sheet's unused entries are 19 % more
    bytes at rank 10.  Returns ``(x, y)``."""
    ranks = list(sides.users)
    span = {"mesh": sides.mesh, "group": sides.group}
    x = {q: als_ops._half(sides.users[q], y[q], reg, alpha, implicit, policy, solve, gram)
         for q in ranks}
    parts = [sides.items[q].partials(x[q], alpha, implicit, policy) for q in ranks]
    a_i, b_i, n_i = (collective.psum_group([p[j] for p in parts], axis, **span)
                     for j in range(3))
    del parts
    g_x = (collective.psum_group([als_ops._factor_gram(x[q], gram) for q in ranks], axis,
                                 **span)
           if implicit else [None] * len(ranks))
    y = {q: als_ops.regularized_solve(a_i[k], b_i[k], n_i[k], reg, g_x[k], solve)
         for k, q in enumerate(ranks)}
    return x, y


def _block_body_2d(sides: BlockSides, x: Dict[Rank, torch.Tensor],
                   y: Dict[Rank, torch.Tensor], reg: float, alpha: float, implicit: bool,
                   axis: str, policy: str, solve: Callable, gram: Callable):
    """One alternating iteration of the 2-D layout: each side's blocks
    all-gathered, the other side's blocks solved from their own edges,
    the Gram the psum of the block Grams.  Returns ``(x, y)`` blocks."""
    ranks = list(sides.users)
    span = {"mesh": sides.mesh, "group": sides.group}

    def half(dst_sides, src):
        full = collective.all_gather_group([src[q] for q in ranks], axis, **span)
        g = (collective.psum_group([als_ops._factor_gram(src[q], gram) for q in ranks], axis,
                                   **span)
             if implicit else [None] * len(ranks))
        out = {}
        for k, q in enumerate(ranks):
            a, b, n = dst_sides[q].partials(full[k], alpha, implicit, policy)
            out[q] = als_ops.regularized_solve(a, b, n, reg, g[k], solve)
        return out

    x = half(sides.users, y)
    return x, half(sides.items, x)


def _run(sides: BlockSides, x0, y0, max_iter: int, reg: float, alpha: float,
         implicit: bool, axis: str, policy: str, solve: Callable, gram: Callable,
         body: Callable = _block_body):
    x, y = dict(x0), dict(y0)
    for _ in range(max_iter):
        faults.maybe_fault("fit.execute")  # utils/faults.py, once an iteration
        x, y = body(sides, x, y, reg, alpha, implicit, axis, policy, solve, gram)
    return x, y


def als_block_run(sides: BlockSides, x0: Dict[Rank, torch.Tensor],
                  y0: Dict[Rank, torch.Tensor], max_iter: int, reg: float, alpha: float,
                  mesh: Mesh, *, implicit: bool, policy: str = "f32",
                  solve: Callable = als_kernel.solve_normal_eq,
                  gram: Callable = als_kernel.factor_gram
                  ) -> Tuple[Dict[Rank, torch.Tensor], Dict[Rank, torch.Tensor]]:
    """Block-parallel ALS (both feedback modes) on COO sides: ``(x
    blocks, y copies)``, one per data rank.  ``x0[q]`` is rank ``q``'s
    (upb, r) user block, ``y0[q]`` its (n_items, r) copy of the items;
    ``solve`` and ``gram`` are the kernel wrappers (the card check passes
    their plain versions)."""
    if sides.grouped:
        raise ValueError("als_block_run takes COO sides; grouped ones run "
                         "als_block_run_grouped")
    return _run(sides, x0, y0, max_iter, reg, alpha if implicit else 0.0, implicit,
                mesh.axis_names[0], policy, solve, gram)


def als_block_run_grouped(sides: BlockSides, x0: Dict[Rank, torch.Tensor],
                          y0: Dict[Rank, torch.Tensor], max_iter: int, reg: float,
                          alpha: float, mesh: Mesh, *, implicit: bool, policy: str = "f32",
                          solve: Callable = als_kernel.solve_normal_eq,
                          gram: Callable = als_kernel.factor_gram
                          ) -> Tuple[Dict[Rank, torch.Tensor], Dict[Rank, torch.Tensor]]:
    """:func:`als_block_run` on grouped sides: the same iteration and
    psums with the grouped moments."""
    if not sides.grouped:
        raise ValueError("als_block_run_grouped takes grouped sides")
    return _run(sides, x0, y0, max_iter, reg, alpha if implicit else 0.0, implicit,
                mesh.axis_names[0], policy, solve, gram)


def als_block_run_2d(sides: BlockSides, x0: Dict[Rank, torch.Tensor],
                     y0: Dict[Rank, torch.Tensor], max_iter: int, reg: float, alpha: float,
                     mesh: Mesh, *, implicit: bool, policy: str = "f32",
                     solve: Callable = als_kernel.solve_normal_eq,
                     gram: Callable = als_kernel.factor_gram
                     ) -> Tuple[Dict[Rank, torch.Tensor], Dict[Rank, torch.Tensor]]:
    """The 2-D layout (:func:`_block_body_2d`) on COO sides from
    :func:`prepare_coo_inputs_2d`: ``(x blocks, y blocks)``, ``x0[q]`` rank
    ``q``'s (upb, r) user block and ``y0[q]`` its (ipb, r) item block."""
    if sides.grouped:
        raise ValueError("als_block_run_2d takes COO sides; grouped ones run "
                         "als_block_run_grouped_2d")
    return _run(sides, x0, y0, max_iter, reg, alpha if implicit else 0.0, implicit,
                mesh.axis_names[0], policy, solve, gram, _block_body_2d)


def als_block_run_grouped_2d(sides: BlockSides, x0: Dict[Rank, torch.Tensor],
                             y0: Dict[Rank, torch.Tensor], max_iter: int, reg: float,
                             alpha: float, mesh: Mesh, *, implicit: bool,
                             policy: str = "f32",
                             solve: Callable = als_kernel.solve_normal_eq,
                             gram: Callable = als_kernel.factor_gram
                             ) -> Tuple[Dict[Rank, torch.Tensor], Dict[Rank, torch.Tensor]]:
    """:func:`als_block_run_2d` on grouped sides from
    :func:`prepare_grouped_inputs_2d`."""
    if not sides.grouped:
        raise ValueError("als_block_run_grouped_2d takes grouped sides")
    return _run(sides, x0, y0, max_iter, reg, alpha if implicit else 0.0, implicit,
                mesh.axis_names[0], policy, solve, gram, _block_body_2d)


def gather_user_factors(x: Dict[Rank, torch.Tensor], mesh: Mesh, offsets: np.ndarray
                        ) -> np.ndarray:
    """The (n, r) factors of a block-sharded table on the host (the user
    factors, or the item factors of the 2-D layout): each block's real
    rows, its padding rows dropped.  Across processes a collective: the
    blocks come from the processes that hold them, and every process
    gets the whole table."""
    ranks = data_ranks(mesh)
    if _cross(mesh):
        blocks = collective.all_gather_group([x[q] for q in ranks if mesh.is_local(q)],
                                             mesh.axis_names[0], mesh=mesh, group=ranks)
        full = blocks[0].cpu().numpy()
        per = full.shape[0] // len(ranks)
        rows = [full[b * per: b * per + int(offsets[b + 1] - offsets[b])]
                for b in range(len(ranks))]
    else:
        rows = [x[q][: int(offsets[b + 1] - offsets[b])].cpu().numpy()
                for b, q in enumerate(ranks)]
    return np.concatenate(rows, axis=0)
