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

:func:`kernel_launch` / :func:`book_launch` book every launch of the five
kernels into the metrics registry and the active span, under the JAX
package's label values (:data:`LABELS`).
"""

from __future__ import annotations

import contextlib
import time

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


# -- launch telemetry ------------------------------------------------------------

# the JAX package's label values, so a dashboard reads both packages alike
LABELS = {
    "kmeans_accumulate": "kmeans.accumulate",
    "pca_moments": "pca.moments",
    "als_solve": "als.solve",
    "als_factor_gram": "als.factor_gram",
    "ring_reduce": "ring.allreduce",
}


def note_emitted(kernel: str) -> None:
    """Census of kernels built into a larger program, counted once a
    build (the JAX package's trace-time census; the port's wrappers
    launch their kernels directly and book :func:`book_launch`)."""
    from oap_mllib_tpu_torch.telemetry import metrics as _tm

    _tm.counter(
        "oap_kernel_emitted_total", {"kernel": kernel},
        help="Pallas kernels emitted into compiled programs "
             "(trace-time census, not a dispatch count)",
    ).inc()


def book_launch(kernel: str, seconds: float, n: int = 1) -> None:
    """Book ``n`` launches of ``kernel`` (a label of :data:`LABELS`) that
    took ``seconds`` of host dispatch wall: ``oap_kernel_launches_total``,
    one ``oap_kernel_dispatch_seconds`` observation a call, and
    ``attrs["kernels"]`` on the thread's active span.  The wrappers call
    it exactly where they add to their ``LAUNCHES`` tables, so the
    counts agree."""
    from oap_mllib_tpu_torch.telemetry import metrics as _tm
    from oap_mllib_tpu_torch.telemetry.spans import current_span

    lab = {"kernel": kernel}
    _tm.counter("oap_kernel_launches_total", lab,
                help="Pallas kernel wrapper dispatches by kernel").inc(n)
    _tm.histogram("oap_kernel_dispatch_seconds", lab,
                  help="Per-dispatch wall of Pallas kernel wrappers "
                       "(compile included on first shape)").observe(seconds)
    sp = current_span()
    if sp is not None:
        kernels = sp.attrs.setdefault("kernels", {})
        kernels[kernel] = kernels.get(kernel, 0) + n


@contextlib.contextmanager
def kernel_launch(kernel: str):
    """Time one dispatch (the C entry's call: an asynchronous launch) and
    book it with :func:`book_launch` when it succeeded; a launch that
    raises books nothing, as its ``LAUNCHES`` entry stays."""
    t0 = time.perf_counter()
    yield
    book_launch(kernel, time.perf_counter() - t0)
