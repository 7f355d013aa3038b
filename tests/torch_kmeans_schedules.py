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


# -- the wide route (csrc/assign_wide.cuh, d > 256) ---------------------------

WIDE_BM = 128  # rows an item of the wide route


def form_stage(xs, mode):
    """A stage's rows (BM, 64) f32 formed into their bf16 parts as the
    block forms them: rounded to nearest at the bf16 tiers, the exact
    truncation split at highest."""
    return split_round(xs, 1) if mode != "highest" else list(split_trunc(xs))


def form_layout(xs, mode):
    """The formed parts' bytes as the block writes them: [part][row][128
    bytes], 16-byte chunk c of row r at c ^ (r % 8)."""
    parts = form_stage(xs, mode)
    rows = xs.shape[0]
    out = np.zeros(len(parts) * rows * 128, np.uint8)
    for p, part in enumerate(parts):
        raw = part.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint8).reshape(rows, 128)
        for r in range(rows):
            for ch in range(8):
                dst = p * rows * 128 + r * 128 + ((ch ^ (r & 7)) << 4)
                out[dst:dst + 16] = raw[r, ch * 16:ch * 16 + 16]
    return out


def read_formed(buf, rows, part):
    """Part ``part`` of a formed stage (rows, 64) as a K-major,
    128-byte-swizzled wgmma descriptor reads it (k-step ks at 32 ks bytes,
    value kk at 2 kk, the chunk index XOR-ed by r % 8)."""
    out = np.zeros((rows, CHUNK), np.float32)
    base = part * rows * 128
    for r in range(rows):
        for col in range(CHUNK):
            byte = 32 * (col // 16) + 2 * (col % 16)
            addr = base + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15))
            bits = int(buf[addr]) | (int(buf[addr + 1]) << 8)
            out[r, col] = np.array([bits << 16], np.uint32).view(np.float32)[0]
    return torch.from_numpy(out)


def _chunks(a, dpad):
    padded = torch.zeros((a.shape[0], dpad))
    padded[:, :a.shape[1]] = a
    return [padded[:, q:q + CHUNK] for q in range(0, dpad, CHUNK)]


def wide_cross(x, c, mode):
    """x . c^T (n, k) f32 as the wide route's products form it: the depth
    in 64-deep chunks (zeros past d) in chunk order, each chunk's product
    an f32 sum of exact bf16 products added into the running sums; at
    highest x0 c0 in one accumulator and the five smaller products in a
    second, added once at the end.  Returns (acc, lo) with lo None at the
    bf16 tiers."""
    dpad = -(-x.shape[1] // CHUNK) * CHUNK
    cp = split_round(c, 1 if mode != "highest" else 3)
    xc = [_chunks(a, dpad) for a in form_stage(x, mode)]
    cc = [_chunks(b, dpad) for b in cp]
    acc = torch.zeros((x.shape[0], c.shape[0]))
    lo = None if mode != "highest" else torch.zeros_like(acc)
    for q in range(dpad // CHUNK):
        acc = acc + xc[0][q] @ cc[0][q].T
        if lo is not None:
            for a, b in ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0)):
                lo = lo + xc[a][q] @ cc[b][q].T
    return acc, lo


def wide_xsq(x):
    """|x|^2 as the block sums it: each of a row's 8 threads runs one sum
    over its 8 values of every stage, chunk after chunk (a fused
    multiply-add each, emulated in f64), then an xor tree over the 8
    threads."""
    dpad = -(-x.shape[1] // CHUNK) * CHUNK
    s = torch.zeros((x.shape[0], 8))
    for xs in _chunks(x, dpad):
        # thread ch holds the stage's values 8 ch .. 8 ch + 7
        for e in range(8):
            v = xs[:, torch.arange(8) * 8 + e].double()
            s = (s.double() + v * v).float()
    # the xor tree: 1, then 2, then 4 (every lane ends with one sum)
    s = s[:, 0::2] + s[:, 1::2]
    s = s[:, 0::2] + s[:, 1::2]
    return s[:, 0] + s[:, 1]


def wide_scores(x, c, mode, need_cost):
    """(n, kpad) scores of the wide route, kpad = k in whole tiles of its
    width, the padded centers at -inf (|c|^2 = +inf)."""
    geo = kmeans_kernel.assign_geometry(x.shape[0], c.shape[0], x.shape[1], mode)
    n, k = x.shape[0], c.shape[0]
    kpad = -(-k // geo.tile) * geo.tile
    acc, lo = wide_cross(x, c, mode)
    v = torch.zeros((n, kpad))
    v[:, :k] = acc if lo is None else acc + lo
    csq = torch.full((kpad,), float("inf"))
    csq[:k] = torch.sum(c * c, dim=1)
    if need_cost:
        return -torch.clamp_min(wide_xsq(x)[:, None] + csq[None, :] - 2.0 * v, 0.0)
    return v - 0.5 * csq[None, :]


def wide_items(n, k, d, mode):
    """The wide route's items in launch order (``Walk`` in
    assign_wide.cuh): ``(row block, group, center tiles)`` for every block
    of 128 rows and every group, the groups of a row block consecutive."""
    geo = kmeans_kernel.assign_geometry(n, k, d, mode)
    tiles = -(-k // geo.tile)
    return [(rb, g, list(range(g * geo.per_group, min(tiles, (g + 1) * geo.per_group))))
            for rb in range(geo.blocks) for g in range(geo.groups)]


def wide_select(sc, n, k, d, mode):
    """The wide route's (label, best score) per row from (n, kpad) scores:
    per item (a block of 128 rows and a group of center tiles) each thread
    of a row's quad keeps its columns' best in rising order with a strict
    > (tile by tile, merged into its running best by (score desc, index
    asc)), the quad reduces over lane distances 1 and 2, and the merge
    pass reduces the groups in order."""
    geo = kmeans_kernel.assign_geometry(n, k, d, mode)
    bn = geo.tile
    part_s = torch.full((geo.groups, n), float("-inf"))
    part_i = torch.zeros((geo.groups, n), dtype=torch.int64)
    for rb, g, tiles in wide_items(n, k, d, mode):
        rows = torch.arange(rb * WIDE_BM, min(n, (rb + 1) * WIDE_BM))
        best = torch.full((len(rows), 4), float("-inf"))
        bidx = torch.zeros((len(rows), 4), dtype=torch.int64)
        for tile in tiles:
            for tq in range(4):
                cols = torch.tensor([tile * bn + 8 * j + 2 * tq + e
                                     for j in range(bn // 8) for e in (0, 1)])
                s = sc[rows][:, cols]
                tb, arg = s.max(dim=1)  # the first of equal maxima: a strict >
                tbi = torch.where(tb > float("-inf"), cols[arg], INT_MAX)
                up = _better(tb, tbi, best[:, tq], bidx[:, tq])
                best[:, tq] = torch.where(up, tb, best[:, tq])
                bidx[:, tq] = torch.where(up, tbi, bidx[:, tq])
        for off in (1, 2):
            other = torch.tensor([t ^ off for t in range(4)])
            os, oi = best[:, other], bidx[:, other]
            up = _better(os, oi, best, bidx)
            best, bidx = torch.where(up, os, best), torch.where(up, oi, bidx)
        part_s[g, rows], part_i[g, rows] = best[:, 0], bidx[:, 0]
    bs = torch.full((n,), float("-inf"))
    bi = torch.zeros(n, dtype=torch.int64)
    for g in range(geo.groups):
        up = _better(part_s[g], part_i[g], bs, bi)
        bs, bi = torch.where(up, part_s[g], bs), torch.where(up, part_i[g], bi)
    return bi, bs


def wide_assign(x, c, mode, need_cost):
    """Labels and (cost mode) min d2 of every row as the wide route forms
    and selects them."""
    n, d = x.shape
    labels, best = wide_select(wide_scores(x, c, mode, need_cost), n, c.shape[0], d, mode)
    return labels, (-best if need_cost else None)
