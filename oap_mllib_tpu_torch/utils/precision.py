"""Compute-precision policy of a fit, and its kernel tier.

The policy (``Config.compute_precision``, overridden per algorithm by
``Config.kmeans_precision``, ``pca_precision`` or ``als_precision``) is
one of ``f32``, ``tf32`` or ``bf16``;
``auto`` resolves to ``f32`` (the port has no measured parity bound for
the reduced tiers yet).  :func:`kernel_tier` maps it onto the kernels'
tiers: ``f32`` keeps ``Config.matmul_precision``, ``tf32`` is the
bf16 hi/lo-split ``high`` tier, ``bf16`` the single-pass ``default``
tier.  The names keep the JAX package's vocabulary: its "tf32" tier is a
bf16_3x split, not NVIDIA's TF32.

:func:`pdot` and :func:`peinsum` are the policy-aware products of the
JAX package's ``utils/precision.py``: f32 accumulation under every
policy, bf16 operands under ``bf16``, hi/lo splits under ``tf32``.  Grams
and solves stay f32 whatever the policy (their callers pin ``highest``).

The x64 parity lane (``Config.enable_x64``, the JAX package's pins):
K-Means and PCA fits run in float64 (:func:`compute_dtype`), their
kernels run at ``highest`` (:func:`kernel_tier`) and streamed chunks
stage at float64 (:func:`staging_dtype`); every policy resolves to
``f32`` whatever is requested (ALS's too, as in the JAX package), but
ALS reads no x64 otherwise and keeps float32, and the serving plane's
scoring stays f32 (its pins are f32 arrays).

The resilience ladder's precision rung (utils/resilience.resilient_fit)
reads :func:`reduced_active`, whether the failed attempt resolved a
reduced policy, and retries once inside :func:`force_f32`, where
:func:`resolve` answers ``f32`` for every algorithm.  Both are per
thread; :func:`begin_attempt` starts an attempt's record.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.ops.cuda._tiers import bf16_round, split_bf16, tiered_dot

TIERS = ("f32", "tf32", "bf16")
CHOICES = TIERS + ("auto",)
MATMUL_TIERS = ("highest", "high", "default")
ALGOS = ("kmeans", "pca", "als")

# The JAX package's registered bf16-vs-f32 parity bounds per algorithm
# (its utils/precision.py): the brownout ladder's bf16 rung
# (serving/traffic.brownout_precision_override) degrades the scoring of
# an algorithm only when it has one.  ``auto`` does not read them here.
PARITY_BOUNDS = {
    "kmeans": {"centroid_rel": 5e-2, "cost_rel": 1e-2},
    "pca": {"subspace_rad": 5e-2, "ratio_abs": 1e-2},
    "als": {"factor_rel": 5e-2, "rmse_rel": 2e-2},
}


def _check(field: str, value: str, choices) -> str:
    if value not in choices:
        raise ValueError(f"{field} must be one of {choices}, got {value!r}")
    return value


_tls = threading.local()


def begin_attempt() -> None:
    """Start one fit attempt's record of resolved policies."""
    _tls.resolved = []


def reduced_active() -> bool:
    """Whether the current attempt resolved a reduced policy (bf16 or
    tf32): only then does the ladder take its precision rung."""
    return any(p != "f32" for p in getattr(_tls, "resolved", []))


@contextlib.contextmanager
def force_f32():
    """A scope in which :func:`resolve` answers ``f32`` for every
    algorithm: the precision rung's retry."""
    prev = getattr(_tls, "force_f32", False)
    _tls.force_f32 = True
    try:
        yield
    finally:
        _tls.force_f32 = prev


def x64_active(algo: str = "kmeans", cfg=None) -> bool:
    """Whether ``algo`` runs on the x64 parity lane: ``enable_x64`` set
    and a K-Means or PCA fit (ALS reads no x64, as in the JAX package)."""
    return bool((cfg or get_config()).enable_x64) and algo in ("kmeans", "pca")


def compute_dtype(algo: str = "kmeans", cfg=None) -> torch.dtype:
    """The dtype ``algo``'s fit computes in: float64 on the x64 lane,
    else float32.  Every route takes its dtype here, so none tests the
    flag itself."""
    return torch.float64 if x64_active(algo, cfg) else torch.float32


def resolve(algo: str = "kmeans", cfg=None, record: bool = True) -> str:
    """The resolved policy name of ``algo``'s next fit (``f32`` inside
    :func:`force_f32`, and on the x64 lane whatever is requested, as the
    JAX package pins every algorithm there: reduced precision under f64
    would break the parity contract), recorded for
    :func:`reduced_active` unless ``record`` is False (the serving
    plane's per-request resolution, which belongs to no fit attempt)."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}; expected one of {ALGOS}")
    cfg = cfg or get_config()
    _check("matmul_precision", cfg.matmul_precision, MATMUL_TIERS)
    requested = _check("compute_precision", cfg.compute_precision, CHOICES)
    field = f"{algo}_precision"
    if getattr(cfg, field):
        requested = _check(field, getattr(cfg, field), CHOICES)
    name = ("f32" if requested == "auto" or getattr(_tls, "force_f32", False)
            or cfg.enable_x64 else requested)
    if not record:
        return name
    resolved = getattr(_tls, "resolved", None)
    if resolved is None:
        resolved = _tls.resolved = []
    resolved.append(name)
    return name


def kernel_tier(name: str, matmul_tier: str, algo: str = None) -> str:
    """The kernel tier a policy runs at; ``highest`` for a K-Means or PCA
    fit (``algo``) on the x64 lane, whose kernels' float64 forms have no
    other tier.  Without ``algo`` (scoring, ALS) the x64 lane moves
    nothing."""
    _check("compute precision tier", name, TIERS)
    if algo is not None and x64_active(algo):
        return "highest"
    return {"f32": matmul_tier, "tf32": "high", "bf16": "default"}[name]


def staging_dtype(name: str) -> torch.dtype:
    """The dtype a streamed K-Means or PCA pass stages its data chunks
    at: bfloat16 under the ``bf16`` policy (half the bytes copied to the
    card; the kernels read them back as f32), else the fit's dtype
    (float64 on the x64 lane), as the JAX package's ``staging_dtype``."""
    _check("compute precision tier", name, TIERS)
    return torch.bfloat16 if name == "bf16" else compute_dtype()


def apply_matmul_flags(tier: str) -> None:
    """At the ``highest`` tier, turn TF32 off for torch's f32 matmuls and
    convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), so every f32 product outside
    the kernels (initialisation, scoring) runs in full FP32.  These are
    process-wide torch flags; the reduced tiers leave them as they are."""
    if tier == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def pdot(a: torch.Tensor, b: torch.Tensor, policy: str = "f32",
         tier: str = "highest") -> torch.Tensor:
    """``a @ b`` under a policy, f32 accumulation always: ``f32`` runs at
    ``tier``, ``tf32`` at the hi/lo-split ``high`` tier, ``bf16`` on
    bf16-rounded operands (the JAX package's ``pdot``)."""
    return tiered_dot(a, b, kernel_tier(policy, tier))


def peinsum(subscripts: str, a: torch.Tensor, b: torch.Tensor,
            policy: str = "f32") -> torch.Tensor:
    """Two-operand einsum under a policy (the JAX package's ``peinsum``,
    the ALS moment products): ``f32`` is full f32, ``tf32`` the hi/lo
    split, ``bf16`` rounds both operands; f32 accumulation always."""
    mode = kernel_tier(policy, "highest")
    if mode == "highest":
        return torch.einsum(subscripts, a, b)
    if mode == "default":
        return torch.einsum(subscripts, bf16_round(a), bf16_round(b))
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return (torch.einsum(subscripts, a_hi, b_hi)
            + torch.einsum(subscripts, a_hi, b_lo)
            + torch.einsum(subscripts, a_lo, b_hi))
