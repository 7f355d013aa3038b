"""The port's one build of host C++: every ``csrc/host/*.cpp`` library
is compiled and loaded here.

A library compiles with the host compiler (``g++``; ``$CXX`` names
another) as ``-O3 -std=c++17 -shared -fPIC -pthread`` into the build
directory (``Config.compilation_cache_dir`` when set, else
``oap_mllib_tpu_torch/build/``), named by a hash of its sources, at its
first call: nothing builds at import.  The compiler writes a file of its
own that is renamed into place, so processes that build at once never
load a partial library.  A build and load is booked as one compile
(``progcache.note_build``).

Nothing falls back: a missing compiler or a failed build raises
``RuntimeError`` with the compiler's output, which
``utils/resilience`` classifies as a fault no retry can help.
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
from typing import Sequence

FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def compiler(what: str) -> str:
    """The host compiler's path; raises naming it when it is missing."""
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if not found:
        raise RuntimeError(
            f"host compiler {name!r} not found on PATH: {what} cannot be built"
        )
    return found


def library_path(name: str, sources: Sequence[Path], directory: Path) -> Path:
    """``<directory>/lib<name>-<hash of the sources>.so``."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    return Path(directory) / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path], directory: Path, what: str) -> Path:
    """Build ``lib<name>`` from ``sources`` unless it is built; returns
    its path."""
    out = library_path(name, sources, directory)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(what), *FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{what} build failed ({' '.join(cmd)}), exit "
            f"{proc.returncode}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(build_fn) -> ctypes.CDLL:
    """``ctypes.CDLL`` of the path ``build_fn()`` returns, booked as one
    compile."""
    from oap_mllib_tpu_torch.utils import progcache

    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build_fn()))
    progcache.note_build(time.perf_counter() - t0)
    return lib
