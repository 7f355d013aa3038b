"""Shape bucketing: round row counts up to geometric buckets (the JAX
package's ``data/bucketing.py``, at its default growth factor).

The JAX package buckets padded row counts so one compiled program
serves a range of sizes, with a factor its ``Config.shape_bucketing``
sets.  The port runs eagerly and compiles nothing per shape, so it has
no such setting; it keeps the function at the JAX default factor, 2,
because ``ChunkSource`` rounds its chunk width with it (a source of the
same requested width yields the same chunks and tail counts in both
packages).  Padding rows carry weight 0 wherever they reach a kernel.
"""

from __future__ import annotations

# the JAX package's default (shape_bucketing "on")
BUCKET_FACTOR = 2.0


def bucket_rows(n: int, multiple: int = 1) -> int:
    """The smallest bucket >= ``n`` of the geometric series anchored at
    ``multiple``: each bucket ``ceil(prev * 2)`` rounded up to the
    multiple."""
    if n < 0:
        raise ValueError(f"row count must be >= 0, got {n}")
    multiple = max(1, int(multiple))
    bucket = multiple
    while bucket < n:
        bucket = max(bucket + multiple,
                     -(-int(bucket * BUCKET_FACTOR) // multiple) * multiple)
    return bucket
