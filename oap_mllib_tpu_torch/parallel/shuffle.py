"""The ALS ratings shuffle across processes: the port of the JAX
package's ``parallel/shuffle.py`` ``exchange_ratings``.

The reference packs each rank's ratings, buckets them by user block and
exchanges them with oneCCL ``alltoall`` (the lengths) and ``alltoallv``
(the records).  As in the JAX package, each process buckets its LOCAL
triples by destination block (the stable partition of
ops/als_block.exchange_ratings, input order kept), the processes
allgather the bucket counts, every bucket pads to the largest, and one
``all_to_all`` (gloo ``all_to_all_single``, parallel/collective.py)
moves fixed-shape int32 records ``[user, item, rating bits, valid]`` to
the process that holds each block.  A block's edges are its buckets in
source-process order: the edges the one-process partition of the
process-major concatenation of every process's triples gives, so a fit
across processes builds the same blocks as one process.  Ratings
travel as their exact f32 bits.

The in-process partition (one process holds every block) stays
ops/als_block.exchange_ratings.

:func:`reshard_factor_rows` is the same machinery with factor rows for
payload: the checkpoint restore's redistribution of a factor table onto
a new block layout (utils/checkpoint.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.parallel import collective
from oap_mllib_tpu_torch.parallel.mesh import Mesh


def _pack_records(u, i, r, cap: int) -> np.ndarray:
    """(cap, 4) int32 records: user, item, rating bits, valid flag."""
    rec = np.zeros((cap, 4), np.int32)
    c = len(u)
    rec[:c, 0] = u
    rec[:c, 1] = i
    rec[:c, 2] = np.asarray(r, np.float32).view(np.int32)
    rec[:c, 3] = 1
    return rec


def exchange_ratings(users, items, ratings, mesh: Mesh, ranks, n_users: int, offsets=None
                     ) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
                                np.ndarray]:
    """Move this process's triples to the processes that hold their user
    blocks (a collective: every process calls it with its own triples).
    ``ranks`` are the block ranks in block order (the mesh's first model
    column); block ``b`` holds the users ``[offsets[b], offsets[b + 1])``:
    of the uniform ``ceil(n_users / world)`` split, edges routed to block
    ``min(u // kpb, world - 1)``, or of the given capability-weighted
    ``offsets`` (the same on every process), edges routed by
    ``searchsorted(offsets[1:], u, "right")`` clipped to ``world - 1``.
    Returns ``({b: (users, items, ratings)}`` for the blocks this process
    holds (global ids), the offsets)``."""
    from oap_mllib_tpu_torch.ops.als_block import block_of, block_offsets_of

    users, items = np.asarray(users, np.int64), np.asarray(items, np.int64)
    if n_users >= 2 ** 31 or (len(items) and int(np.max(items)) >= 2 ** 31):
        raise ValueError("ids must fit int32 (the device index dtype)")
    world = len(ranks)
    offsets, weighted = block_offsets_of(world, n_users, offsets)
    block = block_of(users, max(1, -(-n_users // world)), world, offsets if weighted else None)
    order = np.argsort(block.astype(np.int16 if world < 2 ** 15 else np.int64), kind="stable")
    counts = np.bincount(block, minlength=world)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    u, i, r = users[order], items[order], np.asarray(ratings, np.float32)[order]
    # the lengths' pre-exchange: every process's bucket sizes
    (all_counts,) = collective.process_allgather([counts.astype(np.int64)])
    max_bucket = max(1, int(all_counts.max()))
    owner = [mesh.process_of(q) for q in ranks]
    held = [[b for b in range(world) if owner[b] == p] for p in range(mesh.processes)]
    per = max(len(h) for h in held)
    send = []
    for blocks in held:
        rec = np.zeros((per, max_bucket, 4), np.int32)
        for slot, b in enumerate(blocks):
            lo, hi = bounds[b], bounds[b + 1]
            rec[slot] = _pack_records(u[lo:hi], i[lo:hi], r[lo:hi], max_bucket)
        send.append(rec)
    got = collective.all_to_all(send, axis=mesh.axis_names[0])
    out = {}
    for slot, b in enumerate(held[mesh.process]):
        recs = np.concatenate([got[p][slot][:int(all_counts[p, b])] for p in range(len(got))])
        out[b] = (recs[:, 0].astype(np.int64), recs[:, 1].astype(np.int64),
                  recs[:, 2].view(np.float32).copy())
    return out, offsets


def reshard_factor_rows(ids, vals, mesh: Mesh, offsets, per: int) -> Dict[object, torch.Tensor]:
    """Factor-table rows redistributed onto the mesh's block layout: the
    restore path of a checkpoint written by another world or layout.

    Each process passes the host rows it read from its share of the
    checkpoint's shards (``ids`` (m,) global row ids, ``vals`` (m, r)
    float32), every global row on exactly one process.  Rows are
    bucketed by destination block under the NEW ``offsets`` (block ``b``
    holds rows ``[offsets[b], offsets[b + 1])``).  In one process the
    blocks are filled from the host rows directly; across processes one
    ``all_to_all`` moves int32 records ``[id, value bits..., valid]``,
    every bucket padded to the largest, to the process that holds each
    block.  Values travel as their exact f32 bits.  Returns ``{rank: (per,
    r) block}`` for this process's data ranks (the mesh's first model
    column), each on its rank's device; rows no process passed are
    zero."""
    from oap_mllib_tpu_torch.ops.als_block import data_ranks

    ids = np.asarray(ids, np.int64)
    vals = np.asarray(vals, np.float32)
    if ids.size and int(ids.max()) >= 2 ** 31:
        raise ValueError(f"factor row ids must fit int32; got max id {int(ids.max())}")
    axis = mesh.axis_names[0]
    ranks = data_ranks(mesh)
    world, nproc = len(ranks), mesh.processes
    if world % nproc:
        # each process must hold world // nproc blocks (the shuffle's
        # contract): an uneven split would misassign rows, so refuse it
        raise ValueError(f"reshard_factor_rows requires the {axis!r} axis size ({world}) "
                         f"to be a multiple of process_count ({nproc})")
    r = vals.shape[1]
    offsets = np.asarray(offsets, np.int64)
    dst = np.clip(np.searchsorted(offsets, ids, side="right") - 1, 0, world - 1)
    owner = [mesh.process_of(q) for q in ranks]
    if nproc > 1:
        counts = np.bincount(dst, minlength=world).astype(np.int64)
        # r travels with the counts: a width that differs across
        # processes would give the exchange mismatched shapes
        (gathered,) = collective.process_allgather(
            [np.concatenate([np.asarray([r], np.int64), counts])])
        if not (gathered[:, 0] == r).all():
            raise ValueError("reshard_factor_rows: factor width r diverges across processes: "
                             f"{sorted(set(int(x) for x in gathered[:, 0]))}")
        cap = max(1, int(gathered[:, 1:].max()))
        held = [[b for b in range(world) if owner[b] == p] for p in range(nproc)]
        width = max(len(h) for h in held)
        send = []
        for blocks in held:
            rec = np.zeros((width, cap, r + 2), np.int32)
            for slot, b in enumerate(blocks):
                sel = np.nonzero(dst == b)[0]
                rec[slot, :len(sel), 0] = ids[sel]
                rec[slot, :len(sel), 1:r + 1] = vals[sel].view(np.int32)
                rec[slot, :len(sel), r + 1] = 1
            send.append(rec)
        got = collective.all_to_all(send, axis=axis)
        mine = held[mesh.process]
        rows = {b: np.concatenate([got[p][slot] for p in range(nproc)])
                for slot, b in enumerate(mine)}
        rows = {b: rec[rec[:, r + 1] > 0] for b, rec in rows.items()}
        parts = {b: (rec[:, 0].astype(np.int64), rec[:, 1:r + 1].view(np.float32))
                 for b, rec in rows.items()}
    else:
        parts = {b: (ids[dst == b], vals[dst == b]) for b in range(world)}
    out = {}
    for b, q in enumerate(ranks):
        if not mesh.is_local(q):
            continue
        blk = np.zeros((per, r), np.float32)
        bid, bval = parts[b]
        local = bid - offsets[b]
        keep = (local >= 0) & (local < per)
        blk[local[keep]] = bval[keep]
        out[q] = torch.from_numpy(blk).to(mesh.device(q))
    return out
