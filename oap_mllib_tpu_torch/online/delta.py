"""Shared commit of the online paths (the port of the JAX package's
``online/delta.py``).

Every online path (minibatch, ipca, foldin) ends a successful delta with
:func:`commit`: the commit counter, a flight-recorder instant and,
unless ``Config.online_repin`` is "off", the in-place re-pin of every
serving handle bound to the model (serving/registry.repin_model: the
version bumps, the identity-keyed pins re-stage the replaced arrays
once, in-flight requests keep their handle).

The online knobs are validated here, where they are used: a typo raises
at the first delta.
"""

from __future__ import annotations

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.telemetry import flightrec
from oap_mllib_tpu_torch.telemetry import metrics as _tm


def decay_cfg() -> float:
    """Validated ``Config.online_decay``: the per-delta discount of the
    accumulated per-center counts of mini-batch Lloyd, in (0, 1]."""
    decay = get_config().online_decay
    if not (0.0 < float(decay) <= 1.0):
        raise ValueError(f"online_decay must be in (0, 1], got {decay!r}")
    return float(decay)


def foldin_batch_cfg() -> int:
    """Validated ``Config.online_foldin_batch``: 0 solves a whole fold-in
    delta in one launch, a positive value that many destination rows a
    launch."""
    batch = get_config().online_foldin_batch
    if int(batch) < 0:
        raise ValueError(f"online_foldin_batch must be >= 0, got {batch!r}")
    return int(batch)


def repin_cfg() -> str:
    """Validated ``Config.online_repin``: "auto" re-pins served handles
    on every commit, "off" leaves them on the old pins until
    ``registry.repin_model``."""
    mode = get_config().online_repin
    if mode not in ("auto", "off"):
        raise ValueError(f"online_repin must be auto|off, got {mode!r}")
    return mode


def commit(model, kind: str, detail: str = "") -> dict:
    """Commit one delta whose host arrays are already swapped in: the
    counter, the ``delta_commit`` flight-recorder instant, the re-pin.
    Returns ``{"repinned": n}``, the handles whose version advanced."""
    _tm.counter(
        "oap_online_commits_total", {"model": kind},
        help="Committed incremental-fit deltas per model family.",
    ).inc()
    if flightrec.enabled():
        flightrec.record("serve", "delta_commit", f"model={kind} {detail}".strip())
    repinned = 0
    if repin_cfg() == "auto":
        from oap_mllib_tpu_torch.serving import registry

        repinned = registry.repin_model(model)
    return {"repinned": repinned}
