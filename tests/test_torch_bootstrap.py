"""Joining a world of processes (oap_mllib_tpu_torch/parallel/bootstrap.py)
on the CPU: port discovery, the one-process no-op, the errors a
misconfigured or unreachable world raises (held to the JAX package's
text where it has one), a coordinator that comes up late, and the
config's typed environment values."""

import os
import subprocess
import sys
import time

import pytest

from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.parallel import bootstrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a process that joins a two-process world and prints what it saw
_JOIN = """
import sys, time
from oap_mllib_tpu_torch import set_config
from oap_mllib_tpu_torch.parallel import bootstrap, collective
import numpy as np
rank, port = int(sys.argv[1]), int(sys.argv[2])
set_config(device="cpu", bootstrap_timeout=float(sys.argv[3]), collective_timeout=30.0)
print("CONNECTING", flush=True)
t0 = time.monotonic()
assert bootstrap.initialize_distributed(f"127.0.0.1:{port}", 2, rank)
assert bootstrap.initialize_distributed(f"127.0.0.1:{port}", 2, rank)  # idempotent
(got,) = collective.process_allgather([np.asarray([rank], np.int64)])
print("JOINED", rank, got.ravel().tolist(), bootstrap.world_devices(),
      round(time.monotonic() - t0, 2), flush=True)
bootstrap.shutdown()
"""


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "COORDINATOR_PORT", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv("OAP_MLLIB_TPU_" + name, raising=False)
    port_config.reset_config()
    yield
    port_config.reset_config()


def _os_port():
    """A port the kernel assigns (outside the ranges other tests scan)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(rank, port, timeout_s):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", _JOIN, str(rank), str(port), str(timeout_s)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=ROOT)


class TestDiscovery:
    def test_free_port_is_bindable(self):
        import socket

        port = bootstrap.free_port("127.0.0.1", 23456)
        assert port >= 23456
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.close()

    def test_free_port_skips_a_taken_port(self):
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        taken = s.getsockname()[1]
        try:
            assert bootstrap.free_port("127.0.0.1", taken) > taken
        finally:
            s.close()

    def test_default_coordinator(self):
        host, _, port = bootstrap.default_coordinator(24000).rpartition(":")
        assert host == bootstrap.local_ip() and int(port) >= 24000
        assert host.count(".") == 3


class TestOneProcess:
    def test_one_process_is_a_no_op(self):
        assert bootstrap.initialize_distributed() is False
        assert bootstrap.initialize_distributed(None, 1, 0) is False
        assert not bootstrap.is_initialized()
        assert bootstrap.world_size() == 1 and bootstrap.process_index() == 0
        assert bootstrap.world_devices() is None
        bootstrap.shutdown()  # a no-op too

    def test_a_world_config_without_a_join_raises(self):
        """A fit configured for several processes never runs alone."""
        port_config.set_config(num_processes=2)
        with pytest.raises(RuntimeError, match="initialize_distributed"):
            bootstrap.world_size()


class TestMisconfiguredWorld:
    def test_nonzero_rank_without_coordinator_names_what_it_saw(self, monkeypatch):
        """The same ValueError text as the JAX package's, the environment
        values it saw included."""
        import oap_mllib_tpu.config as jax_config
        from oap_mllib_tpu.parallel import bootstrap as jax_bootstrap

        def jax_reset():  # as tests/conftest.py resets it
            with jax_config._lock:
                jax_config._config = None

        monkeypatch.setenv("OAP_MLLIB_TPU_COORDINATOR_PORT", "4567")
        port_config.reset_config()
        jax_reset()
        with pytest.raises(ValueError) as port_err:
            bootstrap.initialize_distributed(None, 2, 1)
        with pytest.raises(ValueError) as jax_err:
            jax_bootstrap.initialize_distributed(None, 2, 1)
        jax_reset()
        assert str(port_err.value) == str(jax_err.value)
        assert "OAP_MLLIB_TPU_COORDINATOR_PORT='4567'" in str(port_err.value)
        assert "process_id=1, num_processes=2" in str(port_err.value)

    def test_unreachable_coordinator_raises_within_the_timeout(self):
        port = _os_port()
        port_config.set_config(bootstrap_timeout=1.5, device="cpu")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError) as err:
            bootstrap.initialize_distributed(f"127.0.0.1:{port}", 2, 1)
        elapsed = time.monotonic() - t0
        assert elapsed < 1.5 + 2.5, elapsed
        text = str(err.value)
        assert f"coordinator=127.0.0.1:{port}" in text and "rank=1/2" in text
        assert "bootstrap_timeout=1.5s" in text and "connection retries" in text
        assert not bootstrap.is_initialized()


class TestJoin:
    def test_late_coordinator_is_retried(self):
        """Rank 1 comes up first and retries until rank 0 hosts the store;
        both join, and the world's device lists are gathered."""
        port = _os_port()
        late = _spawn(1, port, 30.0)
        first = None
        try:
            head = ""
            while "CONNECTING" not in head:  # rank 1 is about to connect
                line = late.stdout.readline()
                assert line, "rank 1 exited before connecting"
                head += line
            # past rank 1's first connection attempt (2 s): it must retry
            time.sleep(2.5)
            first = _spawn(0, port, 30.0)
            # read on through the same buffered stream (communicate would
            # skip what readline buffered); both processes exit within
            # their bootstrap and collective timeouts
            rest = late.stdout.read()
            late.wait(timeout=60)
            outs = [first.communicate(timeout=60)[0], head + rest]
        finally:
            for p in (first, late):
                if p is not None and p.poll() is None:
                    p.kill()
        for rank, (p, out) in enumerate(zip((first, late), outs)):
            assert p.returncode == 0, out[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("JOINED")][-1]
            assert line.startswith(f"JOINED {rank} [0, 1] [['cpu'], ['cpu']]"), line
        assert "; retry 1 in" in outs[1], outs[1][-3000:]
        # the late rank waited for the coordinator: it joined after it
        joined = [ln for ln in outs[1].splitlines() if ln.startswith("JOINED")][-1]
        assert float(joined.split()[-1]) >= 2.5


class TestConfigFromEnv:
    def test_typed_env_values(self, monkeypatch):
        monkeypatch.setenv("OAP_MLLIB_TPU_BOOTSTRAP_TIMEOUT", "2.5")
        monkeypatch.setenv("OAP_MLLIB_TPU_COLLECTIVE_TIMEOUT", "30")
        monkeypatch.setenv("OAP_MLLIB_TPU_NUM_PROCESSES", "3")
        monkeypatch.setenv("OAP_MLLIB_TPU_COORDINATOR_ADDRESS", "10.0.0.7")
        cfg = port_config.Config.from_env()
        assert cfg.bootstrap_timeout == 2.5 and isinstance(cfg.bootstrap_timeout, float)
        assert cfg.collective_timeout == 30.0 and isinstance(cfg.collective_timeout, float)
        assert cfg.num_processes == 3 and isinstance(cfg.num_processes, int)
        assert cfg.coordinator_address == "10.0.0.7"
        assert (cfg.process_id, cfg.coordinator_port) == (0, 0)

    def test_defaults_are_the_jax_packages(self):
        from oap_mllib_tpu.config import Config as JaxConfig

        port, jax = port_config.Config(), JaxConfig()
        for name in ("num_processes", "process_id", "coordinator_address",
                     "coordinator_port", "bootstrap_timeout"):
            assert getattr(port, name) == getattr(jax, name), name

    def test_collective_timeout_is_finite_by_default(self):
        """A peer of a process that fails outside a collective and lives
        on waits at most ``collective_timeout``: ten minutes, not gloo's
        half hour."""
        assert port_config.Config().collective_timeout == 600.0
