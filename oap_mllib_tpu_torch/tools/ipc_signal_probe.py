"""Probe of the signals that can order processes around K5 across
processes, on the card.

    python oap_mllib_tpu_torch/tools/ipc_signal_probe.py [--rounds N] [--layouts one,two]

builds ``tools/ipc_signal_probe.cu`` with ``nvcc`` for ``sm_90a`` into a
shared library in ``--out`` (default ``oap_mllib_tpu_torch/build/``),
then, for each layout, starts two processes that map each other's word
through CUDA IPC and time a ping-pong of ``--rounds`` rounds by each
mechanism of the ``.cu`` file (stream memory operations; a spinning
kernel, once for every round or once a round; a kernel's store with a
stream wait).  Layouts: both processes on card 0 (their contexts share
the card by time slices), and, with two cards or more, cards 0 and 1.
Prints the card's name and power limit, the attributes that bear on the
mechanisms, one ``IPC_SIGNAL`` JSON line for each layout, mechanism and
process (``round_trip_us``: the stream's time over the rounds;
``timeouts``: spins that gave up after ``--spin-limit-ms``; ``stalled``:
the run passed ``--deadline-s`` and was released by the host), and an
``IPC_SIGNAL_SUMMARY`` line.  A mechanism "makes progress" in a layout
when both processes end every round with no timeout and no stall.
Exits non-zero when the build fails or a process fails.  Needs the card
and ``nvcc``; imports neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path
from queue import Empty

HERE = Path(__file__).resolve().parent
MECHANISMS = {0: "stream_memops", 1: "kernel_spin_persistent", 2: "kernel_spin_per_round",
              3: "kernel_store_memop_wait"}
ATTRS = ("can_use_64_bit_stream_mem_ops", "can_use_stream_wait_value_nor",
         "can_flush_remote_writes", "compute_preemption_supported")


def _lib(path: str):
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_alloc.argtypes = [i32, ctypes.c_longlong, ctypes.POINTER(ptr), ptr]
    lib.probe_open.argtypes = [i32, ptr, ctypes.POINTER(ptr)]
    lib.probe_attrs.argtypes = [i32, ctypes.POINTER(i32)]
    lib.probe_zero.argtypes = [i32, ptr]
    lib.probe_run.argtypes = [i32, i32, i32, i32, ctypes.c_uint, ptr, ptr, ctypes.c_longlong,
                              ctypes.c_double, ctypes.POINTER(ctypes.c_float),
                              ctypes.POINTER(i32), ctypes.POINTER(i32)]
    for fn in (lib.probe_alloc, lib.probe_open, lib.probe_attrs, lib.probe_zero, lib.probe_run):
        fn.restype = i32
    return lib


def _worker(path, role, dev, conn, queue, args) -> None:
    """One process of the ping-pong: map the peer's word, then run every
    mechanism twice (a warm run, then the timed one) between barriers."""
    lib = _lib(path)

    def fail(what, err):
        queue.put({"role": role, "error": f"{what}: CUDA error {err}"})
        conn.send(("fail", what))
        raise SystemExit(1)

    mine, handle = ctypes.c_void_p(), (ctypes.c_ubyte * 64)()
    err = lib.probe_alloc(dev, 4096, ctypes.byref(mine), handle)
    if err:
        fail("probe_alloc", err)
    conn.send(bytes(handle))
    got = conn.recv()
    if isinstance(got, tuple):
        raise SystemExit(1)
    peer = ctypes.c_void_p()
    err = lib.probe_open(dev, got, ctypes.byref(peer))
    if err:
        fail("probe_open", err)
    attrs = (ctypes.c_int * 4)()
    lib.probe_attrs(dev, attrs)
    queue.put({"role": role, "attrs": dict(zip(ATTRS, list(attrs)))})
    for mech in args["mechanisms"]:
        for rounds, timed in ((args["warm"], False), (args["rounds"], True)):
            # every run starts from zeroed words: both processes' earlier
            # runs have ended (a run returns when its stream has)
            conn.send("ended")
            conn.recv()
            err = lib.probe_zero(dev, mine)
            if err:
                fail("probe_zero", err)
            conn.send("zeroed")
            conn.recv()
            ms, timeouts, stalled = ctypes.c_float(), ctypes.c_int(), ctypes.c_int()
            err = lib.probe_run(dev, mech, role, rounds, 0, peer, mine,
                                int(args["spin_limit_ms"] * 1e6), args["deadline_s"],
                                ctypes.byref(ms), ctypes.byref(timeouts), ctypes.byref(stalled))
            if timed or err:
                queue.put({"role": role, "mechanism": MECHANISMS[mech], "rounds": rounds,
                           "error": f"CUDA error {err}" if err else None,
                           "ms": ms.value, "round_trip_us": 1e3 * ms.value / rounds,
                           "timeouts": timeouts.value, "stalled": stalled.value})
            if err:
                raise SystemExit(1)


def run_layout(path: str, devs, args) -> list:
    """Both processes of one layout; their records (every one has a
    ``role``)."""
    ctx = mp.get_context("spawn")
    a, b = ctx.Pipe()
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(path, r, devs[r], conn, queue, args))
             for r, conn in ((0, a), (1, b))]
    for p in procs:
        p.start()
    budget = (args["deadline_s"] + 5) * 2 * len(args["mechanisms"]) + 60
    for p in procs:
        p.join(budget)
    out = []
    while True:
        try:
            out.append(queue.get(timeout=0.5))
        except Empty:
            break
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            out.append({"role": r, "error": f"did not end within {budget:.0f} s"})
        elif p.exitcode != 0:
            out.append({"role": r, "error": f"exit code {p.exitcode}"})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(HERE.parent / "build"))
    ap.add_argument("--rounds", type=int, default=2000)
    ap.add_argument("--warm", type=int, default=50)
    ap.add_argument("--spin-limit-ms", type=float, default=1000.0)
    ap.add_argument("--deadline-s", type=float, default=30.0)
    ap.add_argument("--mechanisms", default="0,1,2,3")
    ap.add_argument("--layouts", default="one,two",
                    help="one card, two cards (when the machine has two), or both")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE.parents[1]))
    from oap_mllib_tpu_torch.ops.cuda import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"nvidia-smi: {smi[0] if smi else 'not read'} ({len(smi)} cards)", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libipc_signal_probe-{os.getpid()}.so"
    cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(lib), str(HERE / "ipc_signal_probe.cu")]
    build = subprocess.run(cmd, capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout[-2000:] + build.stderr[-4000:])
        return build.returncode
    opts = {"rounds": args.rounds, "warm": args.warm, "spin_limit_ms": args.spin_limit_ms,
            "deadline_s": args.deadline_s,
            "mechanisms": [int(m) for m in args.mechanisms.split(",")]}
    wanted = args.layouts.split(",")
    layouts = {"one card": (0, 0)} if "one" in wanted else {}
    if len(smi) >= 2 and "two" in wanted:
        layouts["two cards"] = (0, 1)
    summary, failed = {}, False
    for name, devs in layouts.items():
        for rec in run_layout(str(lib), devs, opts):
            rec = {"layout": name, "cards": list(devs), **rec}
            print("IPC_SIGNAL " + json.dumps(rec), flush=True)
            if rec.get("error"):
                failed = True
            if "mechanism" in rec:
                key = f"{name}|{rec['mechanism']}"
                s = summary.setdefault(key, {"progress": True, "round_trip_us": []})
                s["round_trip_us"].append(rec["round_trip_us"])
                s["progress"] &= (not rec["error"] and rec["timeouts"] == 0
                                  and rec["stalled"] == 0)
    print("IPC_SIGNAL_SUMMARY " + json.dumps(summary), flush=True)
    lib.unlink()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
