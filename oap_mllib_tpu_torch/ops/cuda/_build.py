"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``oap_mllib_tpu_torch/build/lib<name>-<hash>.so`` (a plain C interface,
no PyTorch headers, so a build takes seconds) and loads with ``ctypes``.
The hash covers every source under ``csrc/``, so an edited kernel builds
anew and a stale library is never loaded.  Nothing builds at import: the
first launch of a kernel builds it, and :func:`build_all` builds every
kernel at once, one ``nvcc`` process per source, all started together.
``Config.compilation_cache_dir`` names another directory to build into
and load from (utils/progcache.build_dir).  Every build or load of a
library counts in ``progcache.xla_compile_count`` (the port's compiles).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources_hash() -> str:
    """Hash of every kernel source and header under ``csrc/``."""
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def kernel_names():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_dir() -> Path:
    """Where libraries build and load: ``Config.compilation_cache_dir``
    when set, else :data:`BUILD_DIR`."""
    from oap_mllib_tpu_torch.utils import progcache

    return progcache.build_dir(BUILD_DIR)


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{sources_hash()}.so"


def find_nvcc() -> str:
    """``nvcc`` from PATH, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``;
    raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def _nvcc_command(name: str, out: Path):
    return [
        find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names: Iterable[str] = None) -> Dict[str, Path]:
    """Build every kernel not yet built for the current sources, one
    ``nvcc`` per source started together.  Returns ``{name: .so path}``;
    raises with the compiler's output when a build fails."""
    names = list(kernel_names() if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _nvcc_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        (out_dir / f"{name}.ptxas.log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            from oap_mllib_tpu_torch.utils import progcache

            t0 = time.perf_counter()
            path = build_all([name])[name]
            lib = _loaded[name] = ctypes.CDLL(str(path))
            progcache.note_build(time.perf_counter() - t0)
        return lib
