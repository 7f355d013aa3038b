"""Device resolution.

The JAX package falls back to its numpy path when the accelerator is
missing.  The port does not: ``"cuda"`` needs a CUDA device of compute
capability 9.0 (Hopper) and raises ``RuntimeError`` naming what is
missing; the CPU runs only when the caller asks for ``"cpu"``.
:func:`resolve_devices` reads a comma-separated list of devices, the
ranks of a mesh, and requires peer access between every two distinct
cards of it: nothing falls back to copies through the host.

:func:`throughput_probe` measures this process's capability for the
capability-weighted shards (parallel/balance.py),
:func:`pinned_capability` reads a pinned one from
``Config.rank_capability``, and :func:`hardware_identity` labels the
hardware the probe ran on.
"""

from __future__ import annotations

import hashlib
import os
import platform
import socket
import time
from typing import List, Optional, Tuple

import numpy as np
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


# -- capability ------------------------------------------------------------------

# the probe: a chain of (256, 256) f32 products (the compute leg) and a
# 1 MB host-to-device copy from pinned memory (the stream leg), each the
# best of three; reference walls that put an ordinary host near 1.0 (the
# JAX package's: only the ratio between processes matters)
_PROBE_DIM = 256
_PROBE_STREAM_ROWS = 1024
_PROBE_CHAIN = 8
_PROBE_REPS = 3
_PROBE_REF_COMPUTE_S = 2e-3
_PROBE_REF_STREAM_S = 1e-3

_probe_cache: dict = {}


def _probe_device() -> torch.device:
    name = get_config().device.split(",")[0].strip()
    return resolve_device(name or None)


def _timed_s(fn, dev: torch.device) -> float:
    """Seconds of one call of ``fn``: CUDA events on the card, the host
    clock on the CPU."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def throughput_probe(seed: int = 0, device=None) -> float:
    """This process's capability, a relative speed (> 0): the JAX
    package's probe on ``device`` (None: ``Config.device``'s first).
    A chain of eight (256, 256) f32 products, renormalised after each,
    and a 1 MB copy from pinned host memory to the device, each the best
    of three after a warm call, combined harmonically (a process slow at
    either leg is slow).  The inputs come from a numpy generator of
    ``seed``; the result is cached per ``(seed, Config.probe_epoch)``,
    so bumping the epoch measures again."""
    key = (int(seed), int(get_config().probe_epoch))
    if key in _probe_cache:
        return _probe_cache[key]
    dev = resolve_device(device) if device is not None else _probe_device()
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(np.asarray(rng.normal(size=(_PROBE_DIM, _PROBE_DIM)), np.float32)).to(dev)
    host = torch.from_numpy(np.asarray(rng.normal(size=(_PROBE_STREAM_ROWS, _PROBE_DIM)),
                                       np.float32))
    if dev.type == "cuda":
        host = host.pin_memory()
    dst = torch.empty(host.shape, dtype=host.dtype, device=dev)

    def chain():
        y = a
        for _ in range(_PROBE_CHAIN):
            y = y @ a
            y = y * (1.0 / torch.clamp(torch.max(torch.abs(y)), min=1.0))
        return y

    def stream():
        dst.copy_(host, non_blocking=True)

    chain()
    compute_s = min(_timed_s(chain, dev) for _ in range(_PROBE_REPS))
    stream()
    stream_s = min(_timed_s(stream, dev) for _ in range(_PROBE_REPS))
    c = _PROBE_REF_COMPUTE_S / max(compute_s, 1e-9)
    s = _PROBE_REF_STREAM_S / max(stream_s, 1e-9)
    cap = max(float(2.0 / (1.0 / max(c, 1e-9) + 1.0 / max(s, 1e-9))), 1e-6)
    _probe_cache[key] = cap
    return cap


def pinned_capability(cfg=None) -> Optional[float]:
    """This process's pinned capability from ``Config.rank_capability``,
    or None when the probe should run: "" probes, a bare float pins this
    process, a map "0:1.0,1:0.25" pins by process index (an absent
    process probes).  Values must be > 0; anything else raises."""
    cfg = cfg or get_config()
    spec = str(cfg.rank_capability).strip()
    if not spec:
        return None

    def value(tok: str) -> float:
        try:
            v = float(tok)
        except ValueError:
            raise ValueError(
                "rank_capability must be empty (probe), a float, or a comma map "
                f"'rank:value,...'; got {cfg.rank_capability!r}") from None
        if not v > 0:
            raise ValueError(f"rank_capability values must be > 0, got {tok!r}")
        return v

    if ":" not in spec:
        return value(spec)
    from oap_mllib_tpu_torch.parallel import bootstrap

    me = bootstrap.process_index()
    found = None
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError(f"rank_capability map entries must be 'rank:value', got {entry!r}")
        r_s, v_s = entry.split(":", 1)
        try:
            r = int(r_s)
        except ValueError:
            raise ValueError(f"rank_capability map rank must be an int, got {r_s!r}") from None
        v = value(v_s)
        if r == me:
            found = v
    return found


def rank_capability(seed: int = 0) -> Tuple[float, str]:
    """This process's capability and its origin: ``(value, "pinned")``
    from ``Config.rank_capability`` when it covers this process, else
    ``(throughput_probe(seed), "probe")``."""
    pinned = pinned_capability()
    if pinned is not None:
        return pinned, "pinned"
    return throughput_probe(seed), "probe"


def _label(parts: List[str]) -> float:
    """A float64 that holds exactly an integer below 2**48 labelling
    ``parts``: the same on every process (Python's ``hash`` is salted per
    process)."""
    digest = hashlib.sha256("|".join(parts).encode()).digest()
    return float(int.from_bytes(digest[:6], "big"))


def hardware_identity() -> Tuple[float, float]:
    """``(class, devices)``: labels of this process's hardware
    (``Config.device``) for the capability gather.  The class names what
    each of its devices is (a card's model, memory and multiprocessor
    count; the CPU's machine and core count); the devices name where it
    runs (the host, and each card's UUID).  Processes of one class on as
    many processes a device are equal hardware
    (parallel/balance.equal_classes)."""
    classes, where = [], [socket.gethostname()]
    for name in (n.strip() for n in get_config().device.split(",")):
        dev = resolve_device(name or None)
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            p = torch.cuda.get_device_properties(index)
            classes.append(f"cuda/{p.name}/{p.total_memory}/{p.multi_processor_count}")
            where.append(f"cuda/{getattr(p, 'uuid', index)}")
        else:
            classes.append(f"cpu/{platform.machine()}/{os.cpu_count()}")
            where.append("cpu")
    return _label(sorted(classes)), _label(sorted(set(where)))


def reset_probe() -> None:
    """Forget every cached probe."""
    _probe_cache.clear()
