"""The ring kernel's indexing (``csrc/ring_reduce.cu``) emulated with torch
on the CPU, for the port's tests.

Each element of the (rows, cols) buffers takes the fold order of its
segment and column half from ``ring_kernel.fold_order``, exactly as the
kernel places it (``fold_class``: the half from the column against the
padded buffer's split, the segment from the row within its segment
group), and the ranks' values are added in that order.
"""

import torch

from oap_mllib_tpu_torch.ops.cuda import ring_kernel


def emulate_fold(parts, segments=1):
    """What the kernel writes to every rank's output: a list of one
    (rows, cols) tensor per rank."""
    world = len(parts)
    rows, cols = parts[0].shape
    rows_pad, cols_pad = ring_kernel.padded_shape(rows, cols, world, segments)
    seg_rows = rows_pad // segments
    order = torch.tensor(ring_kernel.fold_order(world, segments, rows_pad))
    flat = torch.stack([p.reshape(-1) for p in parts])
    e = torch.arange(rows * cols)
    row, col = e // cols, e % cols
    o = order[(col >= cols_pad // 2).long(), (row % seg_rows) // (seg_rows // world)]
    acc = flat[o[:, 0], e]
    for t in range(1, world):
        acc = flat[o[:, t], e] + acc
    return [acc.reshape(rows, cols).clone() for _ in range(world)]
