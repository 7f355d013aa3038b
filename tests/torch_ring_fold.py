"""The ring kernel's indexing (``csrc/ring_reduce.cu``) emulated with torch
on the CPU, for the port's tests.

The kernel reads everything it needs from one table
(``ring_kernel.fold_table``): the ranks' inputs, their outputs, then the
flattened fold order.  Each element of the (rows, cols) buffers takes the
table row of its segment and column half exactly as the kernel places it
(``fold_row``: the half from the column against the padded buffer's
split, the segment from the row within its segment group), and the
ranks' values are added in that row's order, one fold per rank, however
large the world.
"""

import torch

from oap_mllib_tpu_torch.ops.cuda import ring_kernel


def emulate_fold(parts, segments=1):
    """What the kernel writes to every rank's output: a list of one
    (rows, cols) tensor per rank."""
    world = len(parts)
    rows, cols = parts[0].shape
    order, half, seg_rows, seg = ring_kernel._geometry(rows, cols, world, segments)
    # rank indices stand in for the addresses: table[r] is rank r's input
    table = torch.tensor(ring_kernel.fold_table(range(world), range(world), order))
    flat = torch.stack([p.reshape(-1) for p in parts])
    e = torch.arange(rows * cols)
    row, col = e // cols, e % cols
    cls = (col >= half).long() * world + (row % seg_rows) // seg
    base = 2 * world + cls * world
    acc = flat[table[table[base]], e]
    for t in range(1, world):
        acc = flat[table[table[base + t]], e] + acc
    return [acc.reshape(rows, cols).clone() for _ in range(world)]
