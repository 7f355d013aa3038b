"""The Lloyd kernel's tensor-core route (``csrc/assign_wgmma.cuh``) and its
scan (``csrc/kmeans_accumulate.cu``) emulated with torch on the CPU, for
the port's tests.

- :func:`split_trunc` and :func:`split_round` are the kernel's splits of
  an f32 operand into bf16 parts: x by truncation (the consumer threads),
  the centers by rounding (``prep_kernel``).  Both are exact: the parts
  add back to the operand.
- :func:`cross` is the cross term at a tier as the kernel forms it: one
  product of bf16-rounded operands at high and default; at highest
  x0 c0 in one sum and the five smaller products of the parts in
  another, added at the end, each an f32 product of bf16 values (exact
  products, f32 sums; the tensor core's summation order is not
  emulated).
- :func:`scores` turns the cross term into the kernel's scores, with
  ``|c|^2`` padded by +inf to whole tiles as the kernel pads it.
- :func:`select` runs the kernel's selection: block ``b`` of ``BM`` rows
  starts at tile ``b % tiles``; in each tile every thread of a row's quad
  keeps its own columns' best with a strict ``>`` in rising column
  order, merges it into its running best by (score desc, index asc), and
  the quad reduces by the same order over lane distances 1 and 2.
- :func:`prep_layout` writes the prepared centers' bytes as ``prep_kernel``
  does and :func:`read_operand` reads them back as a K-major,
  128-byte-swizzled wgmma descriptor addresses them.
- :func:`scan` runs the two-kernel exclusive scan in its block order.
"""

import numpy as np
import torch

from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel

BM = 128  # rows per block of the wgmma route
CHUNK = 64  # depth of a stage: one 128-byte row of bf16
SCAN_THREADS, SCAN_PER = 1024, 4
INT_MAX = 2 ** 31 - 1


def _bits(a):
    return a.contiguous().view(torch.int32)


def trunc_bf16(a):
    """The top 16 bits of each f32 value (a bf16 value, as f32)."""
    return (_bits(a) & -65536).view(torch.float32)


def split_trunc(a):
    """x0, x1, x2 of the consumer threads: x0 = trunc(x), x1 = trunc(x -
    x0), x2 = x - x0 - x1; every subtraction is exact."""
    p0 = trunc_bf16(a)
    r = a - p0
    p1 = trunc_bf16(r)
    return p0, p1, r - p1


def split_round(a, parts=3):
    """c0, c1, c2 of ``prep_kernel``: each part the bf16 rounding of what
    the parts before it leave."""
    out, r = [], a
    for _ in range(parts):
        p = r.to(torch.bfloat16).to(torch.float32)
        out.append(p)
        r = r - p
    return out


def cross(x, c, mode):
    """x . c^T (n, k) f32 as the kernel's products form it at a tier."""
    if mode != "highest":
        return split_round(x, 1)[0] @ split_round(c, 1)[0].T
    x0, x1, x2 = split_trunc(x)
    c0, c1, c2 = split_round(c)
    lo = x0 @ c1.T
    for a, b in ((x1, c0), (x0, c2), (x1, c1), (x2, c0)):
        lo = lo + a @ b.T
    return x0 @ c0.T + lo


def tile_width(mode):
    return kmeans_kernel.assign_geometry(1, 1, 1, mode).tile


def scores(x, c, mode, need_cost):
    """(n, kpad) scores, larger better, with the padded centers at -inf;
    kpad is k rounded up to whole tiles of the tier's width."""
    n, k = x.shape[0], c.shape[0]
    bn = tile_width(mode)
    kpad = -(-k // bn) * bn
    acc = torch.zeros((n, kpad))
    acc[:, :k] = cross(x, c, mode)
    csq = torch.full((kpad,), float("inf"))
    csq[:k] = torch.sum(c * c, dim=1)
    if need_cost:
        xsq = torch.sum(x * x, dim=1, keepdim=True)
        return -torch.clamp_min(xsq + csq[None, :] - 2.0 * acc, 0.0)
    return acc - 0.5 * csq[None, :]


def _better(s, i, bs, bi):
    return (s > bs) | ((s == bs) & (i < bi))


def select(sc, bn):
    """The kernel's (label, best score) per row from (n, kpad) scores."""
    n, kpad = sc.shape
    tiles = kpad // bn
    rows = torch.arange(n)
    first = (rows // BM) % tiles
    best = torch.full((n, 4), float("-inf"))
    bidx = torch.zeros((n, 4), dtype=torch.int64)
    for ti in range(tiles):
        tile = (first + ti) % tiles
        for tq in range(4):
            tb = torch.full((n,), float("-inf"))
            tbi = torch.full((n,), INT_MAX, dtype=torch.int64)
            # a row's accumulators hold columns 8 j + 2 tq + e: rising in
            # the register index (j major, e minor)
            for j in range(bn // 8):
                for e in (0, 1):
                    col = tile * bn + 8 * j + 2 * tq + e
                    s = sc[rows, col]
                    up = s > tb
                    tb, tbi = torch.where(up, s, tb), torch.where(up, col, tbi)
            up = _better(tb, tbi, best[:, tq], bidx[:, tq])
            best[:, tq] = torch.where(up, tb, best[:, tq])
            bidx[:, tq] = torch.where(up, tbi, bidx[:, tq])
    for off in (1, 2):
        other = torch.tensor([t ^ off for t in range(4)])
        os, oi = best[:, other], bidx[:, other]
        up = _better(os, oi, best, bidx)
        best, bidx = torch.where(up, os, best), torch.where(up, oi, bidx)
    return bidx[:, 0], best[:, 0]


def assign(x, c, mode, need_cost):
    """Labels and (cost mode) min d2 of every row, as the kernel selects
    them from the emulated scores."""
    labels, best = select(scores(x, c, mode, need_cost), tile_width(mode))
    return labels, (-best if need_cost else None)


def prep_layout(c, mode):
    """The prepared centers' bytes as ``prep_kernel`` writes them:
    [tile][chunk][part][row of the tile][128 swizzled bytes]."""
    k, d = c.shape
    geo = kmeans_kernel.assign_geometry(1, k, d, mode)
    bn, parts = geo.tile, geo.parts
    dpad = -(-d // CHUNK) * CHUNK
    tiles = -(-k // bn)
    padded = torch.zeros((tiles * bn, dpad))
    padded[:k, :d] = c
    split = split_round(padded, parts)
    out = np.zeros(geo.prep_bytes, np.uint8)
    for p, part in enumerate(split):
        raw = part.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint8)
        raw = raw.reshape(tiles * bn, dpad * 2)
        for j in range(tiles * bn):
            tile, r = divmod(j, bn)
            for q in range(dpad // CHUNK):
                stage = tile * (dpad // CHUNK) + q
                base = (stage * parts + p) * bn * 128 + r * 128
                for ch in range(8):
                    dst = base + ((ch ^ (r & 7)) << 4)
                    out[dst:dst + 16] = raw[j, q * 128 + ch * 16:q * 128 + ch * 16 + 16]
    return out


def read_operand(buf, mode, k, d, part):
    """The B operand (tiles * bn, dpad) of one part as wgmma reads it: a
    descriptor at a stage's part, advanced 32 bytes a k-step, addresses
    row r, value kk of the step at r * 128 + 32 ks + 2 kk with the 16-byte
    chunk index XOR-ed by r % 8."""
    geo = kmeans_kernel.assign_geometry(1, k, d, mode)
    bn, parts = geo.tile, geo.parts
    dpad = -(-d // CHUNK) * CHUNK
    tiles = -(-k // bn)
    out = np.zeros((tiles * bn, dpad), np.float32)
    for tile in range(tiles):
        for q in range(dpad // CHUNK):
            base = ((tile * (dpad // CHUNK) + q) * parts + part) * bn * 128
            for r in range(bn):
                for col in range(CHUNK):
                    byte = 32 * (col // 16) + 2 * (col % 16)
                    addr = base + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15))
                    bits = int(buf[addr]) | (int(buf[addr + 1]) << 8)
                    out[tile * bn + r, q * CHUNK + col] = np.array(
                        [bits << 16], np.uint32).view(np.float32)[0]
    return torch.from_numpy(out)


def scan(a):
    """The exclusive scan of integers ``a`` as scan_sums_kernel and
    scan_apply_kernel compute it, block by block."""
    m = a.numel()
    tile = SCAN_THREADS * SCAN_PER
    blocks = kmeans_kernel.scan_tiles(m)
    padded = torch.zeros(blocks * tile, dtype=torch.int64)
    padded[:m] = a
    per_thread = padded.reshape(blocks, SCAN_THREADS, SCAN_PER)
    tile_sum = per_thread.sum(dim=(1, 2))
    out = torch.empty_like(padded).reshape(blocks, SCAN_THREADS, SCAN_PER)
    for b in range(blocks):
        offset = int(tile_sum[:b].sum())
        mine = per_thread[b].sum(dim=1)
        warps = mine.reshape(SCAN_THREADS // 32, 32)
        inc = torch.cumsum(warps, dim=1)  # each warp's shuffle scan
        warp_tot = inc[:, -1]
        warp_pre = torch.cumsum(warp_tot, 0) - warp_tot  # warp 0's scan
        run = offset + (warp_pre[:, None] + inc - warps).reshape(-1)
        for j in range(SCAN_PER):
            out[b, :, j] = run
            run = run + per_thread[b, :, j]
    return out.reshape(-1)[:m]
