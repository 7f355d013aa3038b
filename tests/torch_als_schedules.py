"""The ALS kernels' schedules (``csrc/als_solve.cu``, ``csrc/als_factor_gram.cu``)
emulated with torch and numpy on the CPU, for the port's tests.

- :func:`emulate_solve` runs K3's lane-group schedule: lane ``gl`` of a
  group of ``g = solve_group(r)`` lanes holds row ``gl`` of the triangle
  and the right-hand side's entry ``gl``; every operand a lane takes from
  another lane is read from that lane's row, as the kernel's
  ``__shfl_sync`` does, and entries above the diagonal are updated
  unpredicated, as the kernel updates them.  f32 torch operations, one
  rounding each, like the kernel's ``_rn`` intrinsics.
- :func:`emulate_factor_gram` runs K4's fixed summation order: each
  thread's rows of each stage, the thread partials of a block in q
  order, the blocks of a group in block order, the groups in group
  order.  Its FMAs are float64 products and sums rounded to f32 (a
  double rounding can differ from the card's FMA in the last bit).
"""

import numpy as np
import torch

from oap_mllib_tpu_torch.ops.cuda import als_kernel

W = 4  # the factor Gram's micro-tile edge
THREADS = 256  # its block


def emulate_solve(a, b, n_reg, reg, gram=None):
    """What the solve kernel writes: (n, r) f32 from the same operands as
    ``als_kernel.solve_normal_eq`` (any strides)."""
    n, r = b.shape
    g = als_kernel.solve_group(r)
    spw = 32 // g  # systems a warp (lanes past spw * g idle)
    warps = -(-n // spw)
    f32 = torch.float32
    reg_t = torch.tensor(reg, dtype=f32)

    # row gl of each live system's lower triangle, zeros elsewhere: at
    # g = 32 the warp stages element (row t, column lane) through shared
    # memory, narrower groups load their rows directly; either way each
    # lane ends up with its own row
    row = torch.zeros((warps * spw, g, g), dtype=f32)
    tril = torch.tril(torch.ones((r, r), dtype=torch.bool))
    row[:n, :r, :r] = torch.where(tril, a, torch.zeros((), dtype=f32))
    systems = torch.arange(warps * spw)
    live = systems < n
    gl = torch.arange(g)[None, :]
    rhs = torch.zeros((warps * spw, g), dtype=f32)
    rhs[:n, :r] = b
    nr = torch.zeros(warps * spw, dtype=f32)
    nr[:n] = n_reg
    diag = torch.arange(g)
    row[:, diag, diag] = row[:, diag, diag] + (reg_t * nr)[:, None]
    if gram is not None:
        gpad = torch.zeros((g, g), dtype=f32)
        gpad[:r, :r] = torch.tril(gram)
        row = gpad[None] + row

    # above-diagonal entries are updated too, as the kernel does: no live
    # result reads them
    for j in range(min(g, r)):  # Cholesky, column j
        dj = torch.sqrt(row[:, j, j])  # lane j's diagonal, shuffled
        row[:, :, j] = row[:, :, j] / dj[:, None]
        for i2 in range(j + 1, g):
            if i2 % 4 == 0 and i2 >= r:  # the kernel stops at multiples of 4
                break
            c2 = row[:, i2, j].clone()  # L[i2][j] from lane i2
            row[:, :, i2] = row[:, :, i2] - row[:, :, j] * c2[:, None]
    for j in range(min(g, r)):  # forward
        q = rhs / row[:, :, j]
        rhs = torch.where(gl == j, q, rhs)
        zj = rhs[:, j].clone()
        rhs = torch.where(gl > j, rhs - row[:, :, j] * zj[:, None], rhs)
    for j in reversed(range(min(g, r))):  # back
        p = row[:, :, j] * rhs  # lane k: L[k][j] * w_k
        acc = rhs[:, j].clone()
        for k in range(j + 1, min(g, r)):
            acc = acc - p[:, k]
        wj = acc[:, None] / row[:, :, j]
        rhs = torch.where(gl == j, wj, rhs)
    out = torch.where(nr[:, None] > 0, torch.nan_to_num(rhs), torch.zeros((), dtype=f32))
    return out[live][:, :r].contiguous()


def _fma(x, y, acc):
    """f32 ``fmaf`` through float64: the exact product plus acc, one
    rounding to f32 (float64 arrays holding f32 values)."""
    return (x * y + acc).astype(np.float32).astype(np.float64)


def _bf16(v):
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).float().numpy().astype(
        np.float64)


def thread_tasks(r):
    """Per pass of up to 256 tasks: ``(u0, up, qn)``, and the thread map
    ``tid -> (u, q)`` of each pass as ``(u, q)`` arrays."""
    mt = -(-r // W)
    tasks = mt * (mt + 1) // 2
    passes = []
    for u0 in range(0, tasks, THREADS):
        up = min(tasks - u0, THREADS)
        qn = THREADS // up
        tid = np.arange(THREADS)
        passes.append((u0, up, qn, tid % up, tid // up))
    return mt, tasks, passes


def tile_of(t, m):
    """gram_tile.cuh ``tile_of``: upper-triangle tile t in row-major order."""
    i = 0
    while t >= m - i:
        t -= m - i
        i += 1
    return i, i + t


def emulate_factor_gram(f, mode="highest"):
    """What the factor-Gram kernel writes for an (n, r) f32 numpy table:
    (r, r) f32, and NaN wherever no block wrote."""
    n, r = f.shape
    geo = als_kernel.factor_gram_geometry(n, r)
    blocks, block_rows, stage_rows = geo.blocks, geo.block_rows, geo.stage_rows
    mt, _, passes = thread_tasks(r)
    r4 = W * mt
    x = np.zeros((n + 1, r4))  # row n: a zero row for padded steps
    x[:n, :r] = f.astype(np.float64)
    lo = None
    if mode != "highest":
        hi = _bf16(x)
        lo = _bf16(x - hi) if mode == "high" else None
        x = hi
    part = np.full((blocks, r, r), np.nan, np.float32)
    for u0, up, qn, _, _ in passes:
        # the rows each (block, q) thread walks, stage by stage, in order
        steps = []
        for b in range(blocks):
            lo_row, hi_row = b * block_rows, min(n, (b + 1) * block_rows)
            seq = [[] for _ in range(qn)]
            for s0 in range(lo_row, hi_row, stage_rows):
                rows = min(stage_rows, hi_row - s0)
                for q in range(qn):
                    seq[q].extend(s0 + k for k in range(q, rows, qn))
            steps.append(seq)
        depth = max(len(s) for seq in steps for s in seq)
        idx = np.full((blocks, qn, depth), n)
        for b, seq in enumerate(steps):
            for q, s in enumerate(seq):
                idx[b, q, :len(s)] = s
        acc = np.zeros((blocks, qn, r4, r4))
        for t in range(depth):
            k = idx[:, :, t]
            live = (k < n)[:, :, None, None]
            av = x[k][:, :, :, None]
            bv = x[k][:, :, None, :]
            if mode == "high":
                al, bl = lo[k][:, :, :, None], lo[k][:, :, None, :]
                cross = _fma(av, bl, al * bv)
                new = (_fma(av, bv, acc) + cross).astype(np.float32).astype(np.float64)
            else:
                new = _fma(av, bv, acc)
            acc = np.where(live, new, acc)
        # block sum over q, in q order, for this pass's tasks' entries a <= b
        s = np.zeros((blocks, r4, r4), np.float32)
        for q in range(qn):
            s = s + acc[:, q].astype(np.float32)
        for u in range(u0, u0 + up):
            ta, tb = tile_of(u, mt)
            for i in range(W):
                for j in range(W):
                    ea, eb = ta * W + i, tb * W + j
                    if ea <= eb < r:
                        part[:, ea, eb] = s[:, ea, eb]
    # each group of blocks in block order, then the groups in group order
    top = np.zeros((r, r), np.float32)
    for g in range(geo.groups):
        gs = np.zeros((r, r), np.float32)
        for b in range(g * geo.group_size, min(blocks, (g + 1) * geo.group_size)):
            gs = gs + part[b]
        top = top + gs
    out = np.full((r, r), np.nan, np.float32)
    upper = np.triu(np.ones((r, r), bool))
    out[upper] = top[upper]
    out.T[upper] = top[upper]
    return out
