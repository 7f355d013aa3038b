"""The PCA moments kernel's tensor-core Gram (``csrc/gram_wgmma.cuh``) at
the highest tier (MODE 0) emulated with torch on the CPU, for the port's
tests.

- :func:`split3` is the kernel's split of a formed f32 value into three
  bf16 parts: part 0 its rounding (its truncation where rounding would
  pass bf16's largest finite value), each later part the rounding of
  what the parts before it leave.
- :func:`gram` is the kernel's Gram: the operand formed in f32 ((x -
  mean) * mask), split, and summed over 32-row stages of each row slice
  of ``_gram.wgmma_geometry`` in 16-row k-steps.  Each k-step adds the
  six products of parts whose indices sum to at most 2, a0 b0 into one
  accumulator and a0 b1, a1 b0, a0 b2, a1 b1, a2 b0 (in that order) into
  a second; both restart every ``PROMOTE`` stages and at the end of the
  slice, where they are folded into an f32 total with IEEE adds, the
  small sum into the large one first.  The entries a <= b are written
  with their mirrors, and the slices' partials are summed in slice
  order.  The tensor core's f32 accumulation is modelled as adding each
  k-step's products (summed exactly) to what the accumulator holds,
  rounded toward zero: an error at the scale of what it holds, which
  the restarts and the second accumulator keep small.
  ``accumulators=1, promote=None`` is the design without them: all six
  products into one accumulator, never restarted.
"""

import re

import torch

from oap_mllib_tpu_torch.ops.cuda import _build, _gram

_HEADER = (_build.CSRC / "gram_wgmma.cuh").read_text()


def _constant(name, unit=1):
    """``constexpr int name = a [* unit];`` of ``gram_wgmma.cuh``: a."""
    tail = "" if unit == 1 else rf" \* {unit}"
    return int(re.search(rf"constexpr int {name} = (\d+){tail};", _HEADER).group(1))


BK = _constant("BK")  # rows a stage
KSTEP = _constant("KSTEP", 128)  # rows a wgmma product (128 bytes a row of an atom)
PROMOTE = _constant("PROMOTE")  # stages between the accumulators' restarts
BF16_MAX = torch.tensor([0x7F7F0000], dtype=torch.int32).view(torch.float32)
# the products of parts (p, q), p + q <= 2, in the kernel's order: the
# first into the large accumulator, the rest into the small one
PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def bits(a):
    return a.contiguous().view(torch.int32)


def bf16_rn(a):
    return a.to(torch.bfloat16).to(torch.float32)


def trunc_bf16(a):
    """The top 16 bits of each f32 value (a bf16 value, as f32)."""
    return (bits(a) & -65536).view(torch.float32)


def split3(v):
    """v0, v1, v2 of the kernel's ``form_stage`` at highest: v0 =
    bf16(v) (trunc(v) where |v| passes bf16's largest finite value), v1 =
    bf16(v - v0), v2 = bf16(v - v0 - v1); every subtraction is exact."""
    p0 = torch.where(v.abs() <= BF16_MAX, bf16_rn(v), trunc_bf16(v))
    r = v - p0
    p1 = bf16_rn(r)
    return p0, p1, bf16_rn(r - p1)


def _rz_add(acc, p):
    """f32 ``acc`` plus the f64 sum ``p``, rounded toward zero."""
    s = acc.double() + p
    r = s.float()
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def formed(x, mask=None, mean=None):
    """The kernel's f32 operand: (x - mean) * mask."""
    xc = x if mean is None else x - mean[None, :]
    return xc if mask is None else xc * mask[:, None]


def gram(x, mask=None, mean=None, slice_rows=None, accumulators=2, promote=PROMOTE):
    """The (d, d) f32 Gram as MODE 0 computes it, over row slices of
    ``slice_rows`` (None: ``_gram.wgmma_geometry``'s)."""
    n, d = x.shape
    if slice_rows is None:
        slice_rows = _gram.wgmma_geometry(n, d)[2]
    slices = -(-n // slice_rows)
    stages = -(-slice_rows // BK)
    xc = torch.zeros((slices * stages * BK, d))
    xc[:n] = formed(x, mask, mean)
    # (slices, rows of a slice padded to whole stages, d): rows past a
    # slice's end form zeros, as the kernel's zero-filled copies do
    per = torch.zeros((slices, stages * BK, d))
    for s in range(slices):
        rows = xc[s * slice_rows:min(n, (s + 1) * slice_rows)]
        per[s, :rows.shape[0]] = rows
    parts = [p.double() for p in split3(per)]
    steps = torch.tensor([-(-(min(n, (s + 1) * slice_rows) - s * slice_rows) // BK)
                          for s in range(slices)])
    acc = torch.zeros((slices, d, d))
    lo = torch.zeros((slices, d, d))
    tot = torch.zeros((slices, d, d))
    for t in range(stages):
        live = (t < steps)[:, None, None]
        restart = promote is not None and t % promote == 0
        for ks in range(BK // KSTEP):
            r0 = t * BK + ks * KSTEP
            for i, (p, q) in enumerate(PRODUCTS):
                a, b = parts[p][:, r0:r0 + KSTEP], parts[q][:, r0:r0 + KSTEP]
                prod = a.transpose(1, 2) @ b
                big = i == 0 or accumulators == 1
                held = acc if big else lo
                first = ks == 0 and restart and (big and i == 0 or not big and i == 1)
                held = _rz_add(torch.zeros_like(held) if first else held, prod)
                if big:
                    acc = torch.where(live, held, acc)
                else:
                    lo = torch.where(live, held, lo)
        fold = (t == steps - 1)[:, None, None]
        if promote is not None:
            fold = fold | ((t % promote == promote - 1) & (t < steps))[:, None, None]
        tot = torch.where(fold, tot + (acc + lo), tot)
    # the entries a <= b, each with its mirror
    upper = torch.triu(torch.ones((d, d), dtype=torch.bool))
    part = torch.where(upper, tot, tot.transpose(1, 2))
    out = torch.zeros((d, d))
    for s in range(slices):
        out = out + part[s]
    return out
