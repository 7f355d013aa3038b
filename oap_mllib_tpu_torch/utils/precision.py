"""Compute-precision policy of a fit, and its kernel tier.

The policy (``Config.compute_precision``, overridden per algorithm by
``Config.kmeans_precision``) is one of ``f32``, ``tf32`` or ``bf16``;
``auto`` resolves to ``f32`` (the port has no measured parity bound for
the reduced tiers yet).  :func:`kernel_tier` maps it onto the kernels'
tiers: ``f32`` keeps ``Config.matmul_precision``, ``tf32`` is the
bf16 hi/lo-split ``high`` tier, ``bf16`` the single-pass ``default``
tier.  The names keep the JAX package's vocabulary: its "tf32" tier is a
bf16_3x split, not NVIDIA's TF32.
"""

from __future__ import annotations

import torch

from oap_mllib_tpu_torch.config import get_config

TIERS = ("f32", "tf32", "bf16")
CHOICES = TIERS + ("auto",)
MATMUL_TIERS = ("highest", "high", "default")


def _check(field: str, value: str, choices) -> str:
    if value not in choices:
        raise ValueError(f"{field} must be one of {choices}, got {value!r}")
    return value


def resolve(algo: str = "kmeans", cfg=None) -> str:
    """The resolved policy name of ``algo``'s next fit."""
    if algo != "kmeans":
        raise ValueError(f"unknown algorithm {algo!r}; the port has 'kmeans'")
    cfg = cfg or get_config()
    _check("matmul_precision", cfg.matmul_precision, MATMUL_TIERS)
    requested = _check("compute_precision", cfg.compute_precision, CHOICES)
    if cfg.kmeans_precision:
        requested = _check("kmeans_precision", cfg.kmeans_precision, CHOICES)
    return "f32" if requested == "auto" else requested


def kernel_tier(name: str, matmul_tier: str) -> str:
    """The kernel tier a policy runs at."""
    _check("compute precision tier", name, TIERS)
    return {"f32": matmul_tier, "tf32": "high", "bf16": "default"}[name]


def apply_matmul_flags(tier: str) -> None:
    """At the ``highest`` tier, turn TF32 off for torch's f32 matmuls and
    convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), so every f32 product outside
    the kernels (initialisation, scoring) runs in full FP32.  These are
    process-wide torch flags; the reduced tiers leave them as they are."""
    if tier == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
