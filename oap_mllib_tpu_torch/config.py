"""Configuration of the port: the fields of the JAX package's ``Config``
that the K-Means, PCA and ALS routes read, plus the device.

Env mapping, as in the JAX package: field ``foo_bar`` <- env
``OAP_MLLIB_TPU_FOO_BAR``.

- ``device``: ``"cuda"`` (default) or ``"cpu"``.  Entry points run on the
  card unless the caller asks for the CPU; a missing card raises
  (utils/dispatch.resolve_device), it is never a reason to run elsewhere.
- ``seed``: the seed of estimators that do not set one.
- ``matmul_precision``: the f32 policy's kernel tier ("highest", "high",
  "default").
- ``compute_precision`` / ``kmeans_precision`` / ``pca_precision`` /
  ``als_precision``: the compute-precision policy ("f32", "tf32",
  "bf16"; "auto" resolves to "f32"); a per-algorithm override is empty
  to inherit.
- ``pca_solver``: "auto" or "eigh" (the full eigendecomposition);
  "randomized" is not ported yet and raises.
- ``als_kernel``: the ALS normal-equation layout, "auto" (grouped unless
  its padding blows up, as in the JAX package), "grouped" or "coo".

The JAX package's ``pca_kernel`` and ``als_solve_kernel`` choose between
Pallas and XLA; the port has one device route, its CUDA kernels, so it
has neither field.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

_ENV_PREFIX = "OAP_MLLIB_TPU_"


@dataclasses.dataclass
class Config:
    device: str = "cuda"
    seed: int = 0
    matmul_precision: str = "highest"
    compute_precision: str = "f32"
    kmeans_precision: str = ""
    pca_precision: str = ""
    als_precision: str = ""
    pca_solver: str = "auto"
    als_kernel: str = "auto"

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            raw = os.environ.get(_ENV_PREFIX + f.name.upper())
            if raw is None:
                continue
            setattr(cfg, f.name, int(raw) if f.type in ("int", int) else raw)
        return cfg


_lock = threading.Lock()
_config: Optional[Config] = None


def get_config() -> Config:
    """The process-global config, read from the environment on first use."""
    global _config
    with _lock:
        if _config is None:
            _config = Config.from_env()
        return _config


def set_config(**updates) -> Config:
    """Update the process-global config in place; returns it."""
    cfg = get_config()
    with _lock:
        for k, v in updates.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field: {k!r}")
            setattr(cfg, k, v)
    return cfg


def reset_config() -> None:
    """Drop the global config; the next read starts from the environment."""
    global _config
    with _lock:
        _config = None
