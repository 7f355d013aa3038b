"""Device resolution.

The JAX package falls back to its numpy path when the accelerator is
missing.  The port does not: ``"cuda"`` needs a CUDA device of compute
capability 9.0 (Hopper) and raises ``RuntimeError`` naming what is
missing; the CPU runs only when the caller asks for ``"cpu"``.
:func:`resolve_devices` reads a comma-separated list of devices, the
ranks of a mesh, and requires peer access between every two distinct
cards of it: nothing falls back to copies through the host.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from oap_mllib_tpu_torch.config import get_config

DEVICES = ("cuda", "cpu")
HOPPER = (9, 0)
# PCA feature-count guard, the reference's numFeatures < 65535 (the
# bound on the replicated (d, d) covariance), as in the JAX package
MAX_PCA_FEATURES = 65535


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The torch device for ``device`` (None = ``Config.device``)."""
    name = get_config().device if device is None else str(device)
    if "," in name:
        raise ValueError(
            f"device {name!r} names a mesh; this route runs on one device "
            "(the K-Means, PCA and ALS fits read a device list; a fitted "
            "model scores on one device)"
        )
    if name == "cpu":
        return torch.device("cpu")
    if name.split(":")[0] != "cuda":
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}, CUDA build "
            f"{torch.version.cuda}); pass device='cpu' to run on the CPU"
        )
    dev = torch.device(name)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    cap = torch.cuda.get_device_capability(index)
    if tuple(cap) != HOPPER:
        raise RuntimeError(
            f"device {name!r} is {torch.cuda.get_device_name(index)} with "
            f"compute capability {cap}; the kernels are built for sm_90a "
            f"and need capability {HOPPER}"
        )
    return torch.device("cuda", index)


def resolve_devices(device: Optional[str] = None) -> List[torch.device]:
    """The torch devices of a comma-separated list (None =
    ``Config.device``), one per rank; a device may repeat.  Every CUDA
    entry passes :func:`resolve_device`'s Hopper check, and every two
    distinct cards must reach each other's memory
    (``torch.cuda.can_device_access_peer``, both ways): a pair that
    cannot raises, naming the pair."""
    names = get_config().device if device is None else str(device)
    devs = [resolve_device(n.strip()) for n in names.split(",") if n.strip()]
    if not devs:
        raise ValueError(f"no device named in {names!r}")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh lies on the CPU or on cards, not both: {names!r}")
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"cuda:{a} cannot access the memory of cuda:{b} "
                    "(torch.cuda.can_device_access_peer is False); the "
                    "ring reads its neighbours' buffers directly and "
                    "needs peer access between every two cards of the mesh"
                )
    return devs


def model_device(device: Optional[str], dev: torch.device) -> Optional[str]:
    """The device a fitted model scores on: the fit's own ``device``
    setting (None keeps following ``Config.device``), or ``dev``, the
    device the fit ran on, where that setting names a device list (a
    model scores on one device)."""
    name = get_config().device if device is None else str(device)
    return device if "," not in name else str(dev)
