"""Device resolution.

The JAX package falls back to its numpy path when the accelerator is
missing.  The port does not: ``"cuda"`` needs a CUDA device of compute
capability 9.0 (Hopper) and raises ``RuntimeError`` naming what is
missing; the CPU runs only when the caller asks for ``"cpu"``.
"""

from __future__ import annotations

from typing import Optional

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
