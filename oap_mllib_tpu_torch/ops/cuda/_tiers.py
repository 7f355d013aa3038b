"""Precision tiers shared by the port's kernels and their plain versions.

The same three tiers as the JAX package's kernel plane:

- ``highest``: full-f32 products, f32 accumulation.  On the card this
  means FP32 FMA with TF32 off (utils/precision.apply_matmul_flags).
- ``high``: operands split into bf16 hi + lo parts, recombined from the
  hi*hi, hi*lo and lo*hi products, f32 accumulation (~1e-5 of f32).
- ``default``: single-pass bf16 operands, f32 accumulation (~1e-3).

The compute-precision policy names alias onto the tiers (``f32`` ->
highest, ``tf32`` -> high, ``bf16`` -> default).  A product of two bf16
values is exact in f32, so rounding the operands to bf16 and multiplying
in f32 gives the tiers' products exactly on any device.
"""

from __future__ import annotations

import torch

MODES = ("highest", "high", "default")
# the `mode` argument of the CUDA kernels' C entry points
MODE_CODE = {"highest": 0, "high": 1, "default": 2}
MODE_ALIASES = {"f32": "highest", "tf32": "high", "bf16": "default"}


def check_mode(mode: str) -> str:
    """Canonicalise a tier name; policy names map through
    :data:`MODE_ALIASES` and anything else raises."""
    mode = MODE_ALIASES.get(mode, mode)
    if mode not in MODES:
        raise ValueError(
            f"mode must be one of {MODES} (or a policy alias "
            f"{tuple(MODE_ALIASES)}), got {mode!r}"
        )
    return mode


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 (nearest even) and back to f32."""
    return a.to(torch.bfloat16).to(torch.float32)


def split_bf16(a: torch.Tensor):
    """f32 -> (hi, lo), both bf16-representable f32, with a ~= hi + lo."""
    hi = bf16_round(a)
    lo = bf16_round(a - hi)
    return hi, lo


def tiered_dot(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` at a tier, f32 accumulation always.  The bf16 operands
    are carried as f32 values, so the products are exact and the matmul
    stays in f32 (TF32 must be off for that on the card)."""
    mode = check_mode(mode)
    if mode == "highest":
        return a @ b
    if mode == "default":
        return bf16_round(a) @ bf16_round(b)
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
