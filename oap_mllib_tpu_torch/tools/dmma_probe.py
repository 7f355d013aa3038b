"""Probe of the f64 ``mma.sync`` shapes that ``csrc/dmma_f64.cuh`` wraps.

    python oap_mllib_tpu_torch/tools/dmma_probe.py [--out DIR]

builds ``tools/dmma_probe.cu`` with ``nvcc -Xptxas -v`` for ``sm_90a``
into ``--out`` (default ``oap_mllib_tpu_torch/build/``), prints ptxas's
registers and spills, then runs it: each shape's 16 x 8 tile against a
double loop (``DMMA_TILE`` lines, exact) and each shape's rate on a grid
that fills the card (``DMMA_RATE`` lines, TFLOP/s).  Also prints the
f64 MMA atoms of CuTe's headers (``/usr/local/cutlass/include``), whose
operand layouts the header follows.  Exits non-zero when a tile
disagrees or the build fails.  Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CUTE = Path("/usr/local/cutlass/include/cute")


def cute_atoms() -> None:
    """The F64 MMA atoms' asm and layouts from CuTe's headers."""
    for rel in ("arch/mma_sm80.hpp", "arch/mma_sm90.hpp", "atom/mma_traits_sm80.hpp",
                "atom/mma_traits_sm90.hpp"):
        path = CUTE / rel
        if not path.exists():
            print(f"CUTE {rel}: missing")
            continue
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if re.search(r"F64F64F64F64", line):
                block = lines[i:i + 28]
                print(f"CUTE {rel}:{i + 1}")
                for b in block:
                    if any(w in b for w in ("mma.sync", "Layout", "Shape", "Stride", "using")):
                        print(f"    {b.rstrip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(HERE.parent / "build"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE.parents[1]))
    from oap_mllib_tpu_torch.ops.cuda import _build

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    exe = out / "dmma_probe"
    cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-o", str(exe), str(HERE / "dmma_probe.cu")]
    build = subprocess.run(cmd, capture_output=True, text=True)
    for line in (build.stdout + build.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"ptxas {line.strip()}")
    if build.returncode != 0:
        print(build.stderr[-4000:])
        return build.returncode
    cute_atoms()
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300)
    print(run.stdout, end="")
    print(run.stderr, end="", file=sys.stderr)
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
