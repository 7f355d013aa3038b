"""ALS normal-equation kernels: the port of the JAX package's
``ops/pallas/als_kernel.py``.

- :func:`solve_normal_eq` wraps ``csrc/als_solve.cu`` (``_solve_tile``):
  per system, the lower triangle of ``gram + (a + reg * n_reg * I)``, an
  unrolled Cholesky, both substitutions, ``nan_to_num``, and zero
  factors where ``n_reg == 0``; rank r <= 32, f32 at every tier.  A
  group of :func:`solve_group` lanes solves one system, the triangle's
  rows in the lanes' registers; bit-equal to :func:`solve_plain`.
- :func:`factor_gram` wraps ``csrc/als_factor_gram.cu``
  (``factor_gram_pallas``): ``F^T F`` at a precision tier in one launch,
  sized by :func:`factor_gram_geometry`; the blocks' partials are summed
  in a fixed order inside the launch, behind atomic tickets kept zeroed
  per device and stream.

Each has a plain PyTorch version beside it (:func:`solve_plain`,
:func:`factor_gram_plain`).  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises, with no fallback either way.
The solve reads ``a``, ``b`` and ``n_reg`` through their strides, so the
grouped path's views into one (n, r+1, r+2) moment tensor go in without
a copy.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from oap_mllib_tpu_torch.ops.cuda._tiers import MODE_CODE, check_mode, tiered_dot

SOLVE = "als_solve"
GRAM = "als_factor_gram"
MAX_RANK = 32  # the unrolled-solve bound, as in the JAX package
MAX_GRAM_RANK = 1024  # the factor Gram's staged rows fit shared memory

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


# the fit's rank, which the solve kernel instantiates exactly: r lanes a
# system, three systems to a warp
EXACT_RANK = 10


def solve_group(r: int) -> int:
    """Lanes per system of the solve kernel: r itself at
    :data:`EXACT_RANK`, else the smallest power of two >= r (1 .. 32);
    32 // g systems share a warp."""
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}")
    return r if r == EXACT_RANK else 1 << (r - 1).bit_length()


# the factor Gram's launch: blocks (two per SM of an H100 SXM's 132), rows
# a block stages at once (in floats of F), and a block's rows a multiple
# of this
_GRAM_BLOCKS = 2 * 132
_GRAM_STAGE_FLOATS = 4096
_GRAM_ROW_ALIGN = 4  # 16-byte copies need a block's rows to start at a multiple of 4 floats


class GramGeometry(NamedTuple):
    blocks: int       # blocks of the one launch
    block_rows: int   # rows per block, contiguous (the last block ragged)
    stage_rows: int   # rows per staged copy
    group_size: int   # consecutive blocks per ticket group
    groups: int       # ticket groups


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@lru_cache(maxsize=256)
def factor_gram_geometry(n: int, r: int) -> GramGeometry:
    """The factor Gram's one launch for an (n, r) table: two blocks per
    SM over contiguous row ranges, stages of about 16 KB of F, and
    groups of ~sqrt(blocks) blocks for the kernel's two-level sum."""
    block_rows = _round_up(-(-n // _GRAM_BLOCKS), _GRAM_ROW_ALIGN)
    blocks = -(-n // block_rows)
    stage_rows = min(block_rows, max(_GRAM_ROW_ALIGN, _GRAM_STAGE_FLOATS // r
                                     // _GRAM_ROW_ALIGN * _GRAM_ROW_ALIGN))
    group_size = math.isqrt(blocks - 1) + 1  # ceil(sqrt(blocks))
    return GramGeometry(blocks, block_rows, stage_rows, group_size, -(-blocks // group_size))


def gram_packed(r: int) -> int:
    """Floats of one packed partial of the factor Gram: the r (r + 1) / 2
    entries a <= b, rounded up to a multiple of 4."""
    return _round_up(r * (r + 1) // 2, 4)


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
            lib.als_solve.argtypes = [i32, ptr, i64, i64, i64, ptr, i64, i64, ptr,
                                      i64, ptr, ctypes.c_float, i32, i32, i32,
                                      ptr, ptr]
            lib.als_solve.restype = i32
        else:
            lib.als_factor_gram.argtypes = [i32, ptr, i32, i32, i32, i32, i32,
                                            i32, i32, i32, ptr, ptr, ptr, ptr]
            lib.als_factor_gram.restype = i32
            lib.als_factor_gram_tickets.argtypes = []
            lib.als_factor_gram_tickets.restype = i32
        _libs[name] = lib
    return lib


# per (device index, stream): the factor Gram's zeroed tickets and its
# partials' scratch, grown as needed.  Calls on one stream run in order,
# so they can share both; the kernel leaves the tickets zeroed.
_gram_work = {}


def _gram_workspace(dev: torch.device, stream: int, floats: int):
    key = (dev.index, stream)
    work = _gram_work.get(key)
    if work is None or work[1].numel() < floats:
        tickets = (work[0] if work is not None else
                   torch.zeros(_library(GRAM).als_factor_gram_tickets(), dtype=torch.int32,
                               device=dev))
        work = _gram_work[key] = (tickets, torch.empty(floats, dtype=torch.float32, device=dev))
    return work


def _stream(dev):
    """The raw handle of PyTorch's current stream on ``dev``: the value of
    ``torch.cuda.current_stream(dev).cuda_stream`` without building a
    Stream object, which costs several microseconds of host time a call
    (the factor Gram's whole call takes a few tens)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


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
    err = lib.als_solve(
        b.device.index, a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(),
        n_reg.data_ptr(), n_reg.stride(0),
        None if gram is None else gram.data_ptr(), float(reg), n, r,
        solve_group(r), out.data_ptr(), _stream(b.device),
    )
    if err != 0:
        raise RuntimeError(f"{SOLVE}: CUDA launch failed with error {err}")
    LAUNCHES[SOLVE] += 1
    return out


def factor_gram(f: torch.Tensor, mode: str = "highest") -> torch.Tensor:
    """``F^T F`` (r, r) of an (n, r) f32 contiguous table at a tier: CPU
    takes the plain version, CUDA the Hopper kernel (one launch)."""
    mode = check_mode(mode)
    if not isinstance(f, torch.Tensor) or f.dtype != torch.float32 or f.dim() != 2:
        raise TypeError("factors must be a 2-D float32 torch.Tensor")
    if not f.is_contiguous():
        raise ValueError("factors must be contiguous")
    n, r = f.shape
    if n < 1 or r < 1 or n >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"factor table shape {tuple(f.shape)} out of range")
    dev = f.device
    if dev.type == "cpu":
        return factor_gram_plain(f, mode)
    if dev.type != "cuda":
        raise ValueError(f"{GRAM}: unsupported device {dev}")
    if r > MAX_GRAM_RANK:
        raise ValueError(f"{GRAM}: rank {r} above the kernel's {MAX_GRAM_RANK}")
    fn = _library(GRAM).als_factor_gram
    geo = factor_gram_geometry(n, r)
    stream = _stream(dev)
    tickets, scratch = _gram_workspace(dev, stream, (geo.blocks + geo.groups) * gram_packed(r))
    gram = f.new_empty((r, r))
    err = fn(dev.index, f.data_ptr(), n, r, MODE_CODE[mode], *geo, scratch.data_ptr(),
             tickets.data_ptr(), gram.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{GRAM}: CUDA launch failed with error {err}")
    LAUNCHES[GRAM] += 1
    return gram
