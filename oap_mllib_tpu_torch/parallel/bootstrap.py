"""Joining a world of processes: the port of the JAX package's
``parallel/bootstrap.py`` onto ``torch.distributed``.

The reference forms its world with a oneCCL TCP key-value store: Spark
finds the first executor's address, probes a free port on it from
3000, and every rank connects and blocks until the world is whole.
Here process 0 hosts a ``torch.distributed.TCPStore`` (the key-value
store) and every other process connects to it (or the launcher that
started the world hosts it and every process connects), and the
world's collectives run over the **gloo** backend: host tensors over
TCP.  The cross-process
reductions of a fit are host-mediated, as the JAX package's
``process_allgather`` ones are; the device collective across processes
is the ring kernel over CUDA IPC (ops/cuda/ring_kernel.py).  NCCL is
not used: it refuses two ranks of one communicator on one card, and a
world of two processes on one card is a supported layout.

- :func:`initialize_distributed` joins once per process (idempotent),
  is a no-op returning False for one process, and retries a refused
  coordinator connection (each attempt the ``bootstrap.connect`` fault
  site, utils/faults.py) with backoff under ``Config.bootstrap_timeout``
  before it raises ``RuntimeError`` naming the coordinator, the rank and
  the elapsed time.  A non-zero rank with no coordinator raises
  ``ValueError`` naming the environment values it saw.  There is no
  single-process fallback.
- At the join every process gathers every process's local device list
  (``Config.device``) once: :func:`world_devices`, process 0's devices
  first, is the order of the world's mesh (parallel/mesh.get_mesh).
- :func:`shutdown` closes the ring kernel's IPC handles and leaves the
  world.

Each process selects its own devices (``device="cuda:1"``); masking
cards with ``CUDA_VISIBLE_DEVICES`` hides the peers' cards, and the
ring's IPC mappings across cards then fail.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import time
from typing import List, Optional

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.utils import faults

log = logging.getLogger("oap_mllib_tpu_torch")

_BACKOFF_BASE_S = 0.05  # retry n sleeps ~ base * 2^n, capped below
_BACKOFF_CAP_S = 2.0
_ATTEMPT_S = 2.0  # one connection attempt's own timeout

_state = {"initialized": False, "devices": None, "coordinator": None}


def local_ip() -> str:
    """First non-loopback IPv4 of this host: the source address the
    kernel picks for an outbound route (no packet is sent), else
    127.0.0.1."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))  # UDP connect: no packets
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def free_port(ip: str = "", start: int = 3000) -> int:
    """First bindable TCP port >= ``start`` (the reference scans from
    3000).  SO_REUSEADDR, as the store's own bind sets it, so a port a
    just-closed world left in TIME_WAIT is not skipped."""
    for p in range(start, 65536):
        s = socket.socket()
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((ip or "", p))
            return p
        except OSError:
            continue
        finally:
            s.close()
    raise RuntimeError("no free port found")


def default_coordinator(start_port: int = 3000) -> str:
    """``ip:port`` for process 0 to host the rendezvous on."""
    ip = local_ip()
    return f"{ip}:{free_port(ip, start_port)}"


def is_initialized() -> bool:
    return _state["initialized"]


def world_size() -> int:
    """Processes in the world: 1 until a world of several is joined.  A
    config that names several processes before the join raises, so a
    fit meant for a world never runs alone."""
    if _state["initialized"]:
        import torch.distributed as dist

        return dist.get_world_size()
    n = get_config().num_processes
    if n > 1:
        raise RuntimeError(
            f"Config.num_processes is {n} but this process has not joined the "
            "world: call oap_mllib_tpu_torch.parallel.bootstrap."
            "initialize_distributed() first"
        )
    return 1


def process_index() -> int:
    if _state["initialized"]:
        import torch.distributed as dist

        return dist.get_rank()
    return 0


def world_devices() -> Optional[List[List[str]]]:
    """Every process's local device names, gathered once at the join
    (process order); None in a world of one."""
    return _state["devices"]


def world_layout() -> dict:
    """The world's shape: process count and rank, and the global device
    count."""
    devs = _state["devices"]
    return {"processes": world_size(), "rank": process_index(),
            "devices": sum(len(d) for d in devs) if devs else None}


def _transient(e: Exception) -> bool:
    """A refused or timed-out connection to the coordinator, which a
    later attempt may pass; anything else is not retried."""
    import torch.distributed as dist

    text = str(e).lower()
    return (isinstance(e, (ConnectionError, TimeoutError, dist.DistNetworkError))
            or "refused" in text or "timed out" in text)


def _probe(host: str, port: int, timeout_s: float) -> None:
    """One TCP connection to the coordinator, closed at once: a refused
    connection raises here in microseconds, where the store's own client
    would retry inside its timeout and overrun the join's budget."""
    with socket.create_connection((host, port), timeout=timeout_s):
        pass


def _connect(host: str, port: int, num_processes: int, process_id: int,
             timeout_s: float, coordinator: str, hosts: bool):
    """The store: hosted by process 0 when ``hosts``, connected to by the
    others with retries under ``timeout_s``."""
    import torch.distributed as dist

    t0 = time.monotonic()
    attempt = 0
    while True:
        remaining = timeout_s - (time.monotonic() - t0)
        attempt_s = max(0.1, min(_ATTEMPT_S, remaining))
        try:
            faults.maybe_fault("bootstrap.connect")
            if not hosts:
                _probe(host, port, attempt_s)
            return dist.TCPStore(
                host, port, num_processes, hosts,
                timeout=datetime.timedelta(seconds=attempt_s), wait_for_workers=False)
        except Exception as e:  # noqa: BLE001 - classified below
            elapsed = time.monotonic() - t0
            delay = min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * 2 ** attempt)
            if not _transient(e) or elapsed + delay > timeout_s:
                raise RuntimeError(
                    f"failed to join world: coordinator={coordinator} "
                    f"rank={process_id}/{num_processes} after {elapsed:.1f}s "
                    f"({attempt} connection retries, bootstrap_timeout="
                    f"{timeout_s:g}s): {e}"
                ) from e
            attempt += 1
            log.warning("connect to %s failed (%s); retry %d in %.2fs",
                        coordinator, e, attempt, delay)
            time.sleep(delay)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           launcher_store: bool = False) -> bool:
    """Join the world; True when a world of several processes is (or
    already was) joined, False for one process.  Arguments left None
    come from the config (``num_processes``, ``process_id``,
    ``coordinator_address`` / ``coordinator_port``).

    ``launcher_store``: the process that started the world hosts the
    store at the coordinator address (a ``torch.distributed.TCPStore``
    it bound to a port the kernel assigned, and holds until the world
    ends), as an elastic launcher's agent does; every process, process 0
    included, then connects to it."""
    cfg = get_config()
    num_processes = cfg.num_processes if num_processes is None else int(num_processes)
    process_id = cfg.process_id if process_id is None else int(process_id)
    if num_processes <= 1:
        return False
    if _state["initialized"]:
        return True
    if coordinator_address is None:
        if cfg.coordinator_address:
            coordinator_address = f"{cfg.coordinator_address}:{cfg.coordinator_port or 3000}"
        elif process_id == 0:
            coordinator_address = default_coordinator()
        else:
            # name the env values actually seen: a misconfigured world
            # fails with the evidence instead of a generic instruction
            raise ValueError(
                "non-zero process_id requires a coordinator address "
                "(set OAP_MLLIB_TPU_COORDINATOR_ADDRESS / _PORT); saw "
                "OAP_MLLIB_TPU_COORDINATOR_ADDRESS="
                f"{os.environ.get('OAP_MLLIB_TPU_COORDINATOR_ADDRESS')!r}, "
                "OAP_MLLIB_TPU_COORDINATOR_PORT="
                f"{os.environ.get('OAP_MLLIB_TPU_COORDINATOR_PORT')!r}, "
                f"config.coordinator_address={cfg.coordinator_address!r}, "
                f"process_id={process_id}, num_processes={num_processes}"
            )
    import torch.distributed as dist

    host, _, port = coordinator_address.rpartition(":")
    timeout_s = max(float(cfg.bootstrap_timeout), 0.0)
    log.info("joining world: coordinator=%s size=%d rank=%d",
             coordinator_address, num_processes, process_id)
    store = _connect(host, int(port), num_processes, process_id, timeout_s,
                     coordinator_address, process_id == 0 and not launcher_store)
    coll_s = float(cfg.collective_timeout)
    if coll_s < 0:
        raise ValueError(f"collective_timeout must be >= 0, got {coll_s}")
    kwargs = {"timeout": datetime.timedelta(seconds=coll_s)} if coll_s > 0 else {}
    dist.init_process_group("gloo", store=store, world_size=num_processes,
                            rank=process_id, **kwargs)
    # the world's device order, gathered once: process 0's devices first
    from oap_mllib_tpu_torch.utils.dispatch import resolve_devices

    local = [str(d) for d in resolve_devices()]
    gathered: List[Optional[List[str]]] = [None] * num_processes
    dist.all_gather_object(gathered, local)
    kinds = {name.split(":")[0] for names in gathered for name in names}
    if len(kinds) > 1:
        # the ring's route (plain on the CPU, IPC on the cards) and the
        # mesh's tensors must be one kind on every process
        dist.destroy_process_group()
        raise ValueError(f"a world lies on the CPU or on cards, not both: {gathered}")
    _state.update(initialized=True, devices=gathered, coordinator=coordinator_address)
    return True


def shutdown() -> None:
    """Close the ring kernel's IPC mappings and workspace, then leave the
    world; a no-op when no world was joined."""
    if not _state["initialized"]:
        return
    import torch.distributed as dist

    from oap_mllib_tpu_torch.ops.cuda import ring_kernel

    try:
        ring_kernel.close_ipc()
    finally:
        dist.destroy_process_group()
        _state.update(initialized=False, devices=None, coordinator=None)
