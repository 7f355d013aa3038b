"""Full-sweep top-k: the port of the JAX package's ``serving/sweep.py``.

``recommend_for_all_users`` over the whole user base scores an
(n_users, r) x (r, n_items) product whose naive form builds the
(n_users, n_items) score matrix (38.4 GB at ML-25M's 162,541 x 59,047).
Neither form of the sweep builds it:

- **Streamed sweep** (host-factor models): :func:`sweep_streamed` walks
  the user table in fixed-width row chunks, the last one padded to its
  row bucket, folding each chunk's top-k against the PINNED item table
  (serving/registry.pin) into a preallocated (n_users, k) output.  Its
  loop is the models' own (``batcher.topk_chunked``), at the models'
  chunk width (``batcher.topk_chunk_rows``; ``Config.sweep_chunk_rows``
  overrides it), so the sweep equals ``ALSModel.recommend_for_all_users``
  bit for bit.  Unlike the JAX package's sweep it stages the chunks on
  the calling thread, not through the prefetch pipeline: a chunk is a
  few KB of query rows against a product that takes longer than its
  copy, and handing each one to a staging thread measured slower than
  the plain loop.
- **Factor-sharded ring sweep** (block fits, which keep their live
  layout: models/als.py): each data rank keeps its user block and folds
  a running top-k of it, in :data:`_SHARD_ROW_CHUNK`-row chunks, against
  the item block it holds.  On the 2-D layout the item blocks rotate
  around the mesh ring (``collective.ppermute``, the schedule of
  :func:`_ring_steps`: after ``t`` hops rank ``b`` holds block
  ``(b + t) mod world``); on the replicated layout each rank folds the
  one pinned item table.  Padded item rows score ``-inf`` with id
  ``2**31 - 1``.  The merge orders (score descending, global id
  ascending) on one packed int64 key, the JAX package's two-key sort,
  so ties go to the lowest global id as in the one-device reference.
  Only the (n_users, k) RESULT leaves the ranks; the factor tables
  never gather.  Across processes the ring hops and the result fetch
  go through the host (parallel/collective.py), and a mesh that spans
  an evicted replica (``ha.fleet_evicted``) is refused before launch.
- :func:`shard_factors` places a host table onto a mesh's block layout
  through ``parallel/shuffle.reshard_factor_rows`` (each process
  contributing only its slice of rows); :func:`shard_factors_local`
  blocks it over this process's own devices with no collective, the
  layout a survivor re-forms on (``reform``).

The products and the top-k are ``torch.matmul`` (``psn.pdot``) and
``torch.topk``, as the JAX package computes them outside any Pallas
kernel (``psn.pdot``, ``lax.top_k``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.ops.als_block import Shard, data_ranks
from oap_mllib_tpu_torch.parallel.mesh import Mesh, Rank
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import progcache

# row chunk inside the sharded per-rank fold: bounds the live (chunk,
# items_block) score buffer as the streamed sweep's chunk width does
_SHARD_ROW_CHUNK = 4096
# the id of a padded item row: it sorts after every real row
_PAD_ID = 2**31 - 1


def _sweep_chunk_rows(n_targets: int, r: int) -> int:
    """Rows a sweep chunk scores: ``Config.sweep_chunk_rows`` when set
    (> 0), else the models' top-k chunk width.  Negative raises."""
    from oap_mllib_tpu_torch.serving.batcher import topk_chunk_rows

    cfg_rows = int(get_config().sweep_chunk_rows)
    if cfg_rows < 0:
        raise ValueError(f"sweep_chunk_rows must be >= 0, got {cfg_rows}")
    return cfg_rows or topk_chunk_rows(n_targets, r)


def recommend_for_all_users(model, num_items: int, *, with_scores: bool = False,
                            chunk_rows: int = 0, handle=None, reform=None):
    """Top-``num_items`` item ids (and, with ``with_scores``, scores) for
    EVERY user of ``model``: the ring sweep of a model's live sharded
    layout, else the streamed sweep, equal to
    ``model.recommend_for_all_users`` bit for bit at the default chunk
    width.  ``handle`` is a serving handle whose pinned item table the
    streamed sweep scores against.

    ``reform`` is the eviction hook: when a sharded sweep fails with a
    recovery-plane error (``CollectiveTimeoutError`` /
    ``PeerAbortError``, or the refusal of a mesh that spans an evicted
    replica), ``reform(exc)`` returns a replacement model on the
    survivors' layout (e.g. :func:`shard_factors_local` of the host
    tables) and the sweep runs ONCE more on it, booked in
    ``oap_serve_sweep_reforms_total``.  Without a hook the sweep raises
    ``traffic.ServeError(reason="eviction")`` naming the crash records."""
    from oap_mllib_tpu_torch.utils import recovery

    if num_items < 0:
        raise ValueError(f"top-k count must be >= 0, got {num_items}")
    if getattr(model, "_sharded_user", None) is not None:
        try:
            ids, scores = _sweep_sharded(model, int(num_items), with_scores)
        except recovery.RecoveryError as exc:
            if reform is None:
                from oap_mllib_tpu_torch.serving import traffic

                raise traffic.ServeError(
                    "eviction",
                    "sharded sweep lost a replica mid-flight and no reform hook was "
                    "provided; the mesh spans a dead peer",
                    crash_records=recovery.list_crash_records(str(get_config().crash_dir or "")),
                    cause=exc,
                ) from exc
            _tm.counter(
                "oap_serve_sweep_reforms_total",
                help="Sharded sweeps re-formed on the survivors' layout after a replica "
                     "eviction",
            ).inc()
            return recommend_for_all_users(reform(exc), num_items, with_scores=with_scores,
                                           chunk_rows=chunk_rows, handle=handle, reform=None)
    else:
        ids, scores = sweep_streamed(
            model.user_factors_, _pinned_targets(model, handle), int(num_items),
            with_scores=with_scores, chunk_rows=chunk_rows)
    return (ids, scores) if with_scores else ids


def _pinned_targets(model, handle) -> torch.Tensor:
    """The pinned item table: the handle's generation when it pins one (a
    handle with ``online_repin`` off keeps its own until re-pinned),
    else the model's (one device copy either way).  At the brownout
    ladder's stale rung a replaced table answers from its previous pin
    (``registry.pin``'s ``allow_stale``)."""
    if handle is not None and getattr(handle, "item_dev", None) is not None:
        return handle.item_dev
    from oap_mllib_tpu_torch.serving.registry import pin

    return pin(model._dev_cache, "targets:item", model.item_factors_, model.device,
               allow_stale=True)


def sweep_streamed(query, targets_dev: torch.Tensor, n: int, *, with_scores: bool = False,
                   chunk_rows: int = 0,
                   kind: str = "als") -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Top-``n`` of ``query @ targets.T`` for every query row, in chunks
    of ``chunk_rows`` rows (0: :func:`_sweep_chunk_rows`); host memory is
    the (n_query, n) output plus one chunk."""
    from oap_mllib_tpu_torch.serving import batcher

    rows = int(chunk_rows) or _sweep_chunk_rows(int(targets_dev.shape[0]), query.shape[1])
    out = batcher.topk_chunked(query, targets_dev, n, rows, with_scores=with_scores, kind=kind)
    _tm.counter(
        "oap_serve_sweep_rows_total", {"model": kind},
        help="Query rows swept by full-sweep top-k",
    ).inc(int(query.shape[0]))
    return out


# -- factor-sharded ring sweep ------------------------------------------------


def _ring_steps(world: int):
    """The ring rotation schedule: each hop every rank hands its item
    block to the PREVIOUS rank, so after ``t`` hops rank ``b`` holds
    block ``(b + t) mod world``."""
    return [(i, (i - 1) % world) for i in range(world)]


def _on_card(dev: torch.device):
    """The calling thread's current card set to ``dev`` for a rank's
    work (a no-op off the card)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _merge(best_s, best_i, cand_s, cand_i, n: int):
    """The best ``n`` of two candidate sets per row, ordered (score
    descending, global id ascending) by one packed key a candidate
    (``batcher.topk_keys`` of the global ids), so one ``torch.topk`` is
    the JAX package's two-key sort."""
    from oap_mllib_tpu_torch.serving.batcher import topk_keys

    s = torch.cat([best_s, cand_s], 1)
    i = torch.cat([best_i, cand_i], 1)
    idx = torch.topk(topk_keys(s, i), n, dim=1).indices
    return s.gather(1, idx), i.gather(1, idx)


def _block_topk(x_rows, y_blk, id_lo: int, valid: int, n: int, pol):
    """Top-``min(n, rows of y_blk)`` of a user-row chunk against the item
    block held now: padded item rows (from ``valid`` on) score ``-inf``
    with id :data:`_PAD_ID`."""
    from oap_mllib_tpu_torch.serving.batcher import topk_keys
    from oap_mllib_tpu_torch.utils import precision as psn

    scores = psn.pdot(x_rows, y_blk.T, pol.name, pol.dot_tier)
    local = torch.arange(y_blk.shape[0], device=y_blk.device)
    ok = local < valid
    if valid < y_blk.shape[0]:
        scores = torch.where(ok[None, :], scores, torch.full_like(scores, -float("inf")))
    gids = torch.where(ok, local + id_lo, torch.full_like(local, _PAD_ID)).to(torch.int32)
    # local column order is global id order within a block
    idx = torch.topk(topk_keys(scores), min(n, y_blk.shape[0]), dim=1).indices
    return scores.gather(1, idx), gids[idx]


def _fold_block(best, x_blk, y_blk, id_lo: int, valid: int, n: int, pol):
    """``best`` ((upb, n) scores, ids) folded with one item block, the
    user block in :data:`_SHARD_ROW_CHUNK`-row chunks."""
    best_s, best_i = best
    out_s, out_i = [], []
    for lo in range(0, x_blk.shape[0], _SHARD_ROW_CHUNK):
        hi = lo + _SHARD_ROW_CHUNK
        cs, ci = _block_topk(x_blk[lo:hi], y_blk, id_lo, valid, n, pol)
        s, i = _merge(best_s[lo:hi], best_i[lo:hi], cs, ci, n)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def _sweep_blocks(user: Shard, items: Dict[Rank, torch.Tensor], offsets_i: np.ndarray,
                  item_sharded: bool, n: int, pol) -> Dict[Rank, torch.Tensor]:
    """The per-rank program over this process's data ranks: each rank's
    ``(upb, 2n)`` result, its top-``n`` scores and their ids' bits side
    by side.  ``items`` holds each local rank's item block (2-D layout)
    or its device's copy of the replicated table."""
    mesh = user.mesh
    ranks = data_ranks(mesh)
    world = len(ranks)
    local = [(b, q) for b, q in enumerate(ranks) if mesh.is_local(q)]
    held = {q: items[q] for _, q in local}
    best = {}
    for _, q in local:
        dev = user.blocks[q].device
        rows = user.blocks[q].shape[0]
        best[q] = (torch.full((rows, n), -float("inf"), device=dev),
                   torch.full((rows, n), _PAD_ID, dtype=torch.int32, device=dev))
    for t in range(world if item_sharded else 1):
        for b, q in local:
            if item_sharded:
                cur = (b + t) % world
                id_lo, valid = int(offsets_i[cur]), int(offsets_i[cur + 1] - offsets_i[cur])
            else:
                id_lo, valid = 0, int(held[q].shape[0])
            with _on_card(user.blocks[q].device):
                best[q] = _fold_block(best[q], user.blocks[q], held[q], id_lo, valid, n, pol)
        if item_sharded and t + 1 < world:
            from oap_mllib_tpu_torch.parallel import collective

            moved = collective.ppermute([held[q] for _, q in local], _ring_steps(world),
                                        mesh.axis_names[0], mesh=mesh, group=ranks)
            held = {q: blk for (_, q), blk in zip(local, moved)}
    return {q: torch.cat([s, i.view(torch.float32)], 1) for q, (s, i) in best.items()}


def _replicated_items(model, mesh: Mesh) -> Dict[Rank, torch.Tensor]:
    """Each local data rank's copy of the host item table, pinned in the
    model's cache once per device: under ``targets:item`` on the model's
    device (the name its scoring shares), ``targets:item@<device>`` on
    the others."""
    from oap_mllib_tpu_torch.serving.registry import pin

    table = model.item_factors_
    first = None
    out = {}
    for q in data_ranks(mesh):
        if not mesh.is_local(q):
            continue
        dev = mesh.device(q)
        first = dev if first is None else first
        name = "targets:item" if dev == first else f"targets:item@{dev}"
        out[q] = pin(model._dev_cache, name, table, dev)
    return out


def _sweep_sharded(model, n: int, with_scores: bool):
    """The sweep of a model's live sharded layout: the per-rank fold, then
    one fetch of the (world * upb, n) RESULT, reassembled by the user
    offsets; the factor tables never gather."""
    user: Shard = model._sharded_user
    mesh = user.mesh
    if mesh.processes > 1:
        from oap_mllib_tpu_torch.serving import ha
        from oap_mllib_tpu_torch.utils import recovery

        if ha.fleet_evicted():
            # a collective on a mesh that spans an evicted peer would wait
            # for the dead rank: refuse before launch, so the caller's
            # reform hook re-plans on the survivors' layout
            raise recovery.PeerAbortError(
                "sharded sweep refused: the factor mesh spans an evicted replica (fleet "
                "is local-only); re-form the shards on the survivors before sweeping")
    world = len(data_ranks(mesh))
    pol = _serving_policy_als()
    item_sharded = model._sharded_item is not None
    if item_sharded:
        items, offsets_i = model._sharded_item.blocks, np.asarray(model._sharded_item.offsets)
        m = int(offsets_i[-1])
    else:
        items, offsets_i = _replicated_items(model, mesh), None
        m = int(model.item_factors_.shape[0])
    offsets = np.asarray(user.offsets)
    n_users = int(offsets[-1])
    n = min(int(n), m)
    if n == 0:
        return (np.zeros((n_users, 0), np.int32),
                np.zeros((n_users, 0), np.float32) if with_scores else None)
    key = (pol.name, pol.dot_tier, int(n), bool(item_sharded), progcache.mesh_fingerprint(mesh),
           progcache.array_key(user.blocks, items))
    with progcache.launch("serve.sweep_sharded", key):
        parts = _sweep_blocks(user, items, offsets_i, item_sharded, n, pol)
    if item_sharded and world > 1:
        _note_ring_hops(world)
    both = _fetch_replicated(parts, mesh)
    upb = int(user.per_block)
    out_i = np.zeros((n_users, n), np.int32)
    out_s = np.zeros((n_users, n), np.float32)
    for b in range(world):
        lo, hi = int(offsets[b]), int(offsets[b + 1])
        blk = both[b * upb: b * upb + (hi - lo)]
        out_s[lo:hi] = blk[:, :n]
        out_i[lo:hi] = blk[:, n:].view(np.int32)
    _tm.counter(
        "oap_serve_sweep_rows_total", {"model": "als"},
        help="Query rows swept by full-sweep top-k",
    ).inc(n_users)
    return out_i, (out_s if with_scores else None)


def _note_ring_hops(world: int) -> None:
    """The host-side trace of the ring schedule the sweep just ran: one
    ``ring_hop`` flight-recorder event (and request-ledger event, when a
    traced flush is attached) per rotation hop, item block ``(rank + t)
    mod world`` resident on this process's first rank at hop ``t``."""
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.serving import reqtrace
    from oap_mllib_tpu_torch.telemetry import flightrec

    rank = bootstrap.process_index()
    for t in range(world):
        detail = f"rank={rank} hop={t} block={(rank + t) % world} world={world}"
        flightrec.record("ring_hop", f"hop{t}", detail)
        reqtrace.note_event("ring_hop", detail, time.perf_counter())
    _tm.counter(
        "oap_serve_ring_hops_total",
        help="Ring-rotation hops traced by the sharded sweep",
    ).inc(world)


def _serving_policy_als():
    from oap_mllib_tpu_torch.serving.batcher import resolve_policy

    return resolve_policy("als")


def _fetch_replicated(parts: Dict[Rank, torch.Tensor], mesh: Mesh) -> np.ndarray:
    """Every data rank's block of a per-rank result, concatenated in rank
    order on the host; across processes one gather through
    ``collective.all_gather_group`` (a collective)."""
    ranks = data_ranks(mesh)
    if mesh.spans(ranks):
        from oap_mllib_tpu_torch.parallel import collective

        local = [parts[q] for q in ranks if mesh.is_local(q)]
        return collective.all_gather_group(local, mesh.axis_names[0], mesh=mesh,
                                           group=ranks)[0].cpu().numpy()
    return torch.cat([parts[q].cpu() for q in ranks]).numpy()


def _even_offsets(n: int, world: int):
    """``(offsets, per)`` of ``world`` even blocks of ``n`` rows."""
    per = max(1, -(-n // world))
    return np.minimum(np.arange(world + 1, dtype=np.int64) * per, n), per


def shard_factors(factors: np.ndarray, mesh: Mesh) -> Shard:
    """A HOST factor table placed on the mesh's block layout (even row
    blocks over its data ranks) through the checkpoints' redistribution
    pass (``parallel/shuffle.reshard_factor_rows``): each process
    contributes only its even slice of the rows, and the exchange routes
    every row to its block, so no rank ever holds its peers' rows.
    Returns the ``Shard`` the sharded model surface and the ring sweep
    consume (a collective across processes)."""
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.parallel.shuffle import reshard_factor_rows

    factors = np.asarray(factors, np.float32)
    n = int(factors.shape[0])
    offsets, per = _even_offsets(n, len(data_ranks(mesh)))
    nproc, rank = bootstrap.world_size(), bootstrap.process_index()
    lo, hi = (n * rank) // nproc, (n * (rank + 1)) // nproc
    blocks = reshard_factor_rows(np.arange(lo, hi, dtype=np.int64), factors[lo:hi], mesh,
                                 offsets, per)
    return Shard(blocks, offsets, per, mesh)


def shard_factors_local(factors: np.ndarray) -> Shard:
    """A HOST factor table blocked over THIS process's devices only
    (``Config.device``'s list, one data rank a device), on a fresh mesh
    of this process alone, by plain copies: no collective, usable the
    instant the fleet turns local-only.  :func:`shard_factors` routes
    rows through the exchange across processes, which a survivor must
    not enter after a peer died.  The result drops straight into the
    ring sweep (which then rotates over the local mesh)."""
    from oap_mllib_tpu_torch.utils.dispatch import resolve_devices

    cfg = get_config()
    devs = resolve_devices()
    mesh = Mesh([[d] for d in devs], (cfg.data_axis, cfg.model_axis))
    factors = np.asarray(factors, np.float32)
    n, r = factors.shape
    offsets, per = _even_offsets(int(n), len(devs))
    padded = np.zeros((len(devs) * per, r), np.float32)
    padded[:n] = factors
    blocks = {q: torch.from_numpy(padded[b * per:(b + 1) * per].copy()).to(mesh.device(q))
              for b, q in enumerate(data_ranks(mesh))}
    return Shard(blocks, offsets, per, mesh)
