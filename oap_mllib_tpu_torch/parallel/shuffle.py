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
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

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


def exchange_ratings(users, items, ratings, mesh: Mesh, ranks, n_users: int
                     ) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
                                np.ndarray]:
    """Move this process's triples to the processes that hold their user
    blocks (a collective: every process calls it with its own triples).
    ``ranks`` are the block ranks in block order (the mesh's first model
    column); block ``b`` holds the users ``[offsets[b], offsets[b + 1])``
    of the uniform ``ceil(n_users / world)`` split, and edges route to
    block ``min(u // kpb, world - 1)``.  Returns ``({b: (users, items,
    ratings)}`` for the blocks this process holds (global ids), the
    offsets)``."""
    users, items = np.asarray(users, np.int64), np.asarray(items, np.int64)
    if n_users >= 2 ** 31 or (len(items) and int(np.max(items)) >= 2 ** 31):
        raise ValueError("ids must fit int32 (the device index dtype)")
    world = len(ranks)
    kpb = max(1, -(-n_users // world))
    offsets = np.minimum(np.arange(world + 1) * kpb, n_users)
    block = np.minimum(users // kpb, world - 1)
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
