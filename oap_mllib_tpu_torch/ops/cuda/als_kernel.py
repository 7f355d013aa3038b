"""ALS normal-equation kernels: the port of the JAX package's
``ops/pallas/als_kernel.py``.

- :func:`solve_normal_eq` wraps ``csrc/als_solve.cu`` (``_solve_tile``):
  per system, the lower triangle of ``gram + (a + reg * n_reg * I)``, an
  unrolled Cholesky, both substitutions, ``nan_to_num``, and zero
  factors where ``n_reg == 0``; rank r <= 32, f32 at every tier.
- :func:`factor_gram` wraps ``csrc/als_factor_gram.cu``
  (``factor_gram_pallas``): ``F^T F`` at a precision tier, which shares
  the PCA kernel's Gram routine (``csrc/gram_tile.cuh``).

Each has a plain PyTorch version beside it (:func:`solve_plain`,
:func:`factor_gram_plain`).  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises, with no fallback either way.
The solve reads ``a``, ``b`` and ``n_reg`` through their strides, so the
grouped path's views into one (n, r+1, r+2) moment tensor go in without
a copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from oap_mllib_tpu_torch.ops.cuda._gram import gram_geometry
from oap_mllib_tpu_torch.ops.cuda._tiers import MODE_CODE, check_mode, tiered_dot

SOLVE = "als_solve"
GRAM = "als_factor_gram"
MAX_RANK = 32  # the unrolled-solve bound, as in the JAX package

# launches of the CUDA kernels, by kernel name; each wrapper adds one per
# launch and nowhere else (the plain versions on CPU tensors count none)
LAUNCHES = {SOLVE: 0, GRAM: 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def solve_plain(a: torch.Tensor, b: torch.Tensor, n_reg: torch.Tensor,
                reg: float, gram: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_solve_tile`` in plain PyTorch, batch-last: the same rounded
    operations in the same order as the kernel, on (B,) rows.  Only the
    lower triangle of ``a`` (and of ``gram``) is read.  Returns (n, r)."""
    n, r = b.shape
    # copies (never views: .contiguous() is one when a dim has size 1)
    at = a.permute(1, 2, 0).clone(memory_format=torch.contiguous_format)  # (r, r, B)
    idx = torch.arange(r, device=a.device)
    at[idx, idx] = at[idx, idx] + reg * n_reg
    if gram is not None:
        at = gram[:, :, None] + at
    cols = torch.zeros_like(at)
    for j in range(r):
        d = torch.sqrt(at[j, j])
        cols[j:, j] = at[j:, j] / d
        if j + 1 < r:
            c = cols[j + 1:, j]
            at[j + 1:, j + 1:] = at[j + 1:, j + 1:] - c[:, None] * c[None, :]
    z = b.T.clone(memory_format=torch.contiguous_format)  # (r, B)
    for j in range(r):  # forward: L z = b
        z[j] = z[j] / cols[j, j]
        if j + 1 < r:
            z[j + 1:] = z[j + 1:] - cols[j + 1:, j] * z[j]
    w = torch.empty_like(z)
    for j in reversed(range(r)):  # back: L^T w = z
        acc = z[j]
        for k in range(j + 1, r):
            acc = acc - cols[k, j] * w[k]
        w[j] = acc / cols[j, j]
    out = torch.where(n_reg[None, :] > 0, torch.nan_to_num(w), 0.0)
    return out.T.contiguous()


def factor_gram_plain(f: torch.Tensor, mode: str = "highest") -> torch.Tensor:
    """``F^T F`` at a tier in plain PyTorch."""
    return tiered_dot(f.T, f, check_mode(mode))


def _check_solve(a, b, n_reg, gram):
    for name, t, ndim in (("a", a, 3), ("b", b, 2), ("n_reg", n_reg, 1)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 torch.Tensor")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}: one device only")
    n, r = b.shape
    if tuple(a.shape) != (n, r, r) or n_reg.shape[0] != n:
        raise ValueError(
            f"shapes disagree: a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"n_reg {tuple(n_reg.shape)}"
        )
    if not 1 <= r <= MAX_RANK:
        raise ValueError(
            f"the ALS solve kernel supports rank 1..{MAX_RANK}, got {r} "
            "(larger ranks take als_ops.masked_solve's library route)"
        )
    if gram is not None:
        if gram.dtype != torch.float32 or tuple(gram.shape) != (r, r):
            raise ValueError(f"gram must be float32 ({r}, {r})")
        if gram.device != b.device or not gram.is_contiguous():
            raise ValueError("gram must be contiguous, on b's device")
    if n >= 2 ** 31:
        raise ValueError("n must fit the kernel's 32-bit system index")


_libs = {}


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        from oap_mllib_tpu_torch.ops.cuda import _build

        lib = _build.load(name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == SOLVE:
            lib.als_solve.argtypes = [ptr, i64, i64, i64, ptr, i64, i64, ptr,
                                      i64, ptr, ctypes.c_float, i32, i32, ptr,
                                      ptr]
            lib.als_solve.restype = i32
        else:
            lib.als_factor_gram.argtypes = [ptr, i32, i32, i32, i32, i32, i32,
                                            i32, ptr, ptr, ptr]
            lib.als_factor_gram.restype = i32
        _libs[name] = lib
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def solve_normal_eq(a: torch.Tensor, b: torch.Tensor, n_reg: torch.Tensor,
                    reg: float, gram: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Factors (n, r) of ``gram + (a + reg * n_reg * I)`` x = b, zero where
    ``n_reg == 0``.  f32 operands on one device, any strides: CPU takes
    the plain version, CUDA the Hopper kernel."""
    _check_solve(a, b, n_reg, gram)
    if b.device.type == "cpu":
        return solve_plain(a, b, n_reg, reg, gram)
    if b.device.type != "cuda":
        raise ValueError(f"{SOLVE}: unsupported device {b.device}")
    lib = _library(SOLVE)
    n, r = b.shape
    out = torch.empty((n, r), dtype=torch.float32, device=b.device)
    with torch.cuda.device(b.device):
        err = lib.als_solve(
            a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(),
            n_reg.data_ptr(), n_reg.stride(0),
            None if gram is None else gram.data_ptr(), float(reg), n, r,
            out.data_ptr(), _stream(b.device),
        )
    if err != 0:
        raise RuntimeError(f"{SOLVE}: CUDA launch failed with error {err}")
    LAUNCHES[SOLVE] += 1
    return out


def factor_gram(f: torch.Tensor, mode: str = "highest") -> torch.Tensor:
    """``F^T F`` (r, r) of an (n, r) f32 contiguous table at a tier: CPU
    takes the plain version, CUDA the Hopper kernel."""
    mode = check_mode(mode)
    if not isinstance(f, torch.Tensor) or f.dtype != torch.float32 or f.dim() != 2:
        raise TypeError("factors must be a 2-D float32 torch.Tensor")
    if not f.is_contiguous():
        raise ValueError("factors must be contiguous")
    n, r = f.shape
    if n < 1 or r < 1 or n >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"factor table shape {tuple(f.shape)} out of range")
    if f.device.type == "cpu":
        return factor_gram_plain(f, mode)
    if f.device.type != "cuda":
        raise ValueError(f"{GRAM}: unsupported device {f.device}")
    lib = _library(GRAM)
    tm, m, slices, slice_rows = gram_geometry(n, r)
    part = torch.empty((slices, r, r), dtype=torch.float32, device=f.device)
    gram = torch.empty((r, r), dtype=torch.float32, device=f.device)
    with torch.cuda.device(f.device):
        err = lib.als_factor_gram(
            f.data_ptr(), n, r, MODE_CODE[mode], tm, m, slices, slice_rows,
            part.data_ptr(), gram.data_ptr(), _stream(f.device),
        )
    if err != 0:
        raise RuntimeError(f"{GRAM}: CUDA launch failed with error {err}")
    LAUNCHES[GRAM] += 1
    return gram
