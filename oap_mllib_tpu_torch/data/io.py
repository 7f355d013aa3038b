"""Durable writes for model persistence: tmp file + ``os.replace``, so a
reader never sees a torn file (the JAX package's ``data/io.py``
primitives, copied)."""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _atomic_write(path: str, mode: str, write) -> int:
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".",
        prefix=os.path.basename(path) + ".", suffix=".tmp",
    )
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        nbytes = os.path.getsize(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return nbytes


def atomic_write_json(path: str, payload: dict) -> int:
    """Durably write ``payload`` as JSON.  Returns bytes written."""
    data = json.dumps(payload, sort_keys=True)
    return _atomic_write(path, "w", lambda f: f.write(data))


def atomic_save_npy(path: str, array: np.ndarray) -> int:
    """Durably write one ``.npy`` array.  Returns bytes written."""
    return _atomic_write(path, "wb", lambda f: np.save(f, array))
