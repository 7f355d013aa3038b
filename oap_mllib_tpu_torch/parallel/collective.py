"""In-process collectives over a mesh: the counterparts of the JAX
package's ``parallel/collective.py`` ``psum``, ``all_gather`` and
``ppermute``, which ran inside ``shard_map`` bodies.

The port's mesh is one process holding every rank (parallel/mesh.py),
so a collective takes the per-rank tensors of a group, each on its
rank's device, and returns one tensor per rank on that rank's device.
These are plain torch code, as XLA's psum was compiled code and not a
Pallas kernel; the ring reduction that replaces the moment psums is the
hand-written kernel of ops/cuda/ring_kernel.py.

:func:`psum_group` and :func:`all_gather_group` take one group's
tensors as a list, for callers that run a subset of the mesh's ranks
(the block ALS route runs the first model column).

A census counts every collective by (op, axis), as the JAX package's
``_note_emitted`` counts the collectives emitted into its programs, so
a test can count psums against ring reductions: :func:`emitted`,
:func:`reset_census`.  Each reduction of one group counts once.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from oap_mllib_tpu_torch.parallel.mesh import Mesh, Rank

_CENSUS: collections.Counter = collections.Counter()


def note(op: str, axis: Optional[str] = None) -> None:
    _CENSUS[(op, axis)] += 1


def emitted(op: str, axis: Optional[str] = None) -> int:
    """Collectives ``op`` counted so far (over ``axis``, or any axis when
    None)."""
    return sum(n for (o, a), n in _CENSUS.items()
               if o == op and (axis is None or a == axis))


def reset_census() -> None:
    _CENSUS.clear()


def psum_group(parts: Sequence[torch.Tensor], axis: Optional[str] = None
               ) -> List[torch.Tensor]:
    """The sum of one group's tensors, added in rank order, on every
    rank's device.  Ranks that share a device share the result tensor;
    a group of one returns its tensor unchanged."""
    note("psum", axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return [acc.to(p.device) for p in parts]


def psum(parts: Dict[Rank, torch.Tensor], mesh: Mesh, axis: str
         ) -> Dict[Rank, torch.Tensor]:
    """``lax.psum`` over ``axis`` of per-rank tensors ``{(i, j): t}``:
    every group along the axis sums in rank order (:func:`psum_group`)."""
    out = {}
    for group in mesh.groups(axis):
        for rank, t in zip(group, psum_group([parts[r] for r in group], axis)):
            out[rank] = t
    return out


def all_gather(parts: Dict[Rank, torch.Tensor], mesh: Mesh, axis: str, dim: int = 0
               ) -> Dict[Rank, torch.Tensor]:
    """``lax.all_gather(..., tiled=True)`` over ``axis``: every rank gets
    its group's tensors concatenated along ``dim`` in rank order, on its
    device.  Ranks of a group that share a device share the result."""
    out = {}
    for group in mesh.groups(axis):
        for rank, t in zip(group, all_gather_group([parts[r] for r in group], axis, dim)):
            out[rank] = t
    return out


def all_gather_group(parts: Sequence[torch.Tensor], axis: Optional[str] = None,
                     dim: int = 0) -> List[torch.Tensor]:
    """One group's tensors concatenated along ``dim`` in rank order, on
    every rank's device; ranks that share a device share the result."""
    note("all_gather", axis)
    built = {}
    out = []
    for p in parts:
        if p.device not in built:
            built[p.device] = torch.cat([q.to(p.device) for q in parts], dim=dim)
        out.append(built[p.device])
    return out


def ppermute(parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             axis: Optional[str] = None) -> List[Optional[torch.Tensor]]:
    """``lax.ppermute`` within one group: ``out[dst]`` is a copy of
    ``parts[src]`` on ``dst``'s device for each ``(src, dst)`` of
    ``perm``; a rank that receives nothing gets None."""
    note("ppermute", axis)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(parts[dst].device, copy=True)
    return out
