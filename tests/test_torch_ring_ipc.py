"""K5 across processes: what a CPU can check of the protocol by which
the processes order themselves on the card (no JAX).

The cross-process call (``ring_kernel._ring_launch_ipc``) copies in,
signals "ready" with the call's epoch, waits, folds, signals "folded",
waits and copies out, all on the card's stream, and the host waits once
at the end; it runs only on the card, where ``chip_smoke.py --mp`` holds
it against the plain version.  These tests hold its plain parts: where
the signal words and the member slots lie in each workspace, how the
epoch counts and restarts, how the signal area read at the end of a call
turns into the error every process raises, and how the host's one wait
turns a peer that ended into the recovery plane's PeerAbortError.
"""

import os
import subprocess
import sys
import time

import pytest

from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.config import set_config
from oap_mllib_tpu_torch.ops.cuda import ring_kernel
from oap_mllib_tpu_torch.utils import recovery

SHAPES = [(1000, 130), (13, 37), (2, 128501), (65536, 256)]


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    set_config(device="cpu")
    recovery.reset_stats()
    yield
    port_config.reset_config()
    recovery.reset_stats()


@pytest.mark.parametrize("processes", [1, 2, 4])
def test_signal_area_offsets(processes):
    """A ready and a folded word a process, then the status word, all
    inside the area, which keeps the slots' alignment."""
    area = ring_kernel.signal_area(processes)
    assert area["ready"] == 0
    assert area["folded"] == 4 * processes
    assert area["status"] == 8 * processes
    assert area["words"] == 2 * processes + 1
    assert area["status"] + 4 == 4 * area["words"] <= area["bytes"]
    assert area["bytes"] % 256 == 0 and area["bytes"] < 4 * area["words"] + 256


def test_signal_area_refuses_an_empty_world():
    with pytest.raises(ValueError):
        ring_kernel.signal_area(0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("members", [1, 2, 4])
@pytest.mark.parametrize("processes", [2, 4])
def test_workspace_layout(shape, members, processes):
    """The member slots follow the signal area, each 256-byte aligned
    (16 bytes for the kernel's vector accesses), an input then an output
    a member, large enough for a buffer, none overlapping another or the
    signal words, all inside the workspace."""
    rows, cols = shape
    plan = ring_kernel.workspace_layout(rows, cols, members, processes)
    area, slot = plan["signal"], plan["slot"]
    assert slot >= 4 * rows * cols and slot % 256 == 0
    spans = [(0, 4 * area["words"])]
    for s in range(members):
        for off in (plan["inputs"][s], plan["outputs"][s]):
            assert off % 256 == 0 and off % 16 == 0
            assert off >= area["bytes"]
            spans.append((off, off + 4 * rows * cols))
    assert plan["inputs"][0] == area["bytes"]
    assert plan["outputs"][0] == area["bytes"] + slot
    assert max(end for _, end in spans) <= plan["bytes"]
    assert plan["bytes"] == area["bytes"] + 2 * members * slot
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_epoch_sequence_and_restart():
    """Calls count 1, 2, 3, ...; past the limit the workspace is made
    anew and the count restarts at 1; every process counts alike, so all
    renew at the same call."""
    epoch, seen = 0, []
    for _ in range(5):
        epoch = ring_kernel.next_epoch(epoch)
        seen.append(epoch)
    assert seen == [1, 2, 3, 4, 5]
    limit = 3
    counts = [0, 0, 0]  # three processes
    renewals = [[], [], []]
    for call in range(10):
        for p in range(3):
            nxt = ring_kernel.next_epoch(counts[p], limit)
            if nxt is None:  # a new workspace: the count starts again
                renewals[p].append(call)
                counts[p] = 0
                nxt = ring_kernel.next_epoch(counts[p], limit)
            counts[p] = nxt
    assert renewals[0] == renewals[1] == renewals[2] == [3, 6, 9]
    assert counts == [1, 1, 1]
    assert ring_kernel.next_epoch(ring_kernel.EPOCH_LIMIT) is None
    assert ring_kernel.next_epoch(ring_kernel.EPOCH_LIMIT - 1) == ring_kernel.EPOCH_LIMIT


@pytest.mark.parametrize("epoch", [1, 2, 77, ring_kernel.EPOCH_LIMIT])
def test_signal_word(epoch):
    """A word fits 32 bits; a failed process's word still satisfies its
    peers' wait (>= epoch << 1) and never reaches the next call's."""
    ok, bad = ring_kernel.signal_word(epoch, False), ring_kernel.signal_word(epoch, True)
    assert ok == epoch << 1 and bad == ok | 1
    assert 0 < ok < bad < 2 ** 32
    if epoch < ring_kernel.EPOCH_LIMIT:
        assert bad < ring_kernel.signal_word(epoch + 1, False)


def _area(processes, epoch, ready_bad=(), folded_bad=(), stale=(), ahead=(),
          status_bad=False):
    """A signal area at the end of a call: ``stale`` processes' words of
    the call before, ``ahead`` processes' ready words of the next call."""
    words = []
    for kind, kind_bad in (("ready", ready_bad), ("folded", folded_bad)):
        for q in range(processes):
            e = epoch - 1 if q in stale else epoch + 1 if (kind == "ready" and q in ahead) \
                else epoch
            words.append(ring_kernel.signal_word(e, q in kind_bad))
    words.append(ring_kernel.signal_word(epoch, True) if status_bad else 0)
    return words


@pytest.mark.parametrize("processes", [1, 2, 4])
def test_failed_processes_none(processes):
    assert ring_kernel.failed_processes(_area(processes, 9), processes, 9) == []


@pytest.mark.parametrize("case", [
    dict(ready_bad=(1,), want=[1]),
    dict(folded_bad=(0, 3), want=[0, 3]),
    dict(ready_bad=(2,), folded_bad=(2,), want=[2]),
    dict(stale=(3,), want=[3]),
    # peers already signalling the next call (clean, or failing it) did
    # not fail this one
    dict(ahead=(0, 2), want=[]),
    dict(ahead=(1,), ready_bad=(1,), want=[]),
    dict(ahead=(1,), folded_bad=(1,), want=[1]),
])
def test_failed_processes_named(case):
    want = case.pop("want")
    words = _area(4, 12, **case)
    assert ring_kernel.failed_processes(words, 4, 12) == want


def test_failed_processes_reads_words_as_unsigned():
    """The host copy of the area is int32: a word past 2^31 reads
    negative there and still decodes."""
    epoch = ring_kernel.EPOCH_LIMIT
    signed = [w - 2 ** 32 if w >= 2 ** 31 else w for w in _area(2, epoch, ready_bad=(1,))]
    assert signed[0] < 0
    assert ring_kernel.failed_processes(signed, 2, epoch) == [1]


def test_call_error_names_processes_as_agree_does():
    """Every process raises one RuntimeError naming the failed processes
    in ``collective.agree``'s words, with whether the fold ran and this
    process's own error."""
    words = _area(4, 5, ready_bad=(1, 3), status_bad=True)
    failed = ring_kernel.failed_processes(words, 4, 5)
    own = ValueError("copy in")
    err = ring_kernel.call_error(failed, words, 4, 5, own)
    assert isinstance(err, RuntimeError)
    text = str(err)
    assert "failed on process(es) [1, 3]" in text
    assert "the fold folded nothing" in text and "ValueError('copy in')" in text
    quiet = ring_kernel.call_error([2], _area(4, 5, folded_bad=(2,)), 4, 5, None)
    assert "failed on process(es) [2]" in str(quiet) and "the fold ran" in str(quiet)
    assert "here: None" in str(quiet)


def test_ipc_stats_keys():
    ring_kernel.IPC_STATS.update(calls=3, barrier_s=1.0, device_wait_s=2.0, total_s=3.0)
    ring_kernel.reset_ipc_stats()
    assert ring_kernel.IPC_STATS == {"calls": 0, "barrier_s": 0.0, "device_wait_s": 0.0,
                                     "total_s": 0.0}


def test_process_alive():
    """This process lives; a child that exited is gone both before it is
    reaped (a zombie) and after."""
    assert ring_kernel.process_alive(os.getpid())
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    deadline = time.monotonic() + 30
    while ring_kernel.process_alive(child.pid) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not ring_kernel.process_alive(child.pid)  # exited, not yet reaped
    child.wait()
    assert not ring_kernel.process_alive(child.pid)


class _Event:
    """A CUDA event's ``query`` as the host's wait sees it: not done for
    ``polls`` queries, then done (or never, with polls None)."""

    def __init__(self, polls):
        self.polls, self.queries = polls, 0

    def query(self):
        self.queries += 1
        return self.polls is not None and self.queries > self.polls


def test_await_call_returns_when_done():
    done = _Event(20)
    ring_kernel._await_call(done, {1: os.getpid()})
    assert done.queries == 21


def _gone_pid():
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    return child.pid


def test_await_call_raises_for_a_peer_that_ended(monkeypatch):
    monkeypatch.setattr(ring_kernel, "_LIVENESS_S", 0.0)
    with pytest.raises(ConnectionError, match=r"process\(es\) \[1\] ended"):
        ring_kernel._await_call(_Event(None), {1: _gone_pid()})


@pytest.mark.parametrize("timeout", [0.0, 30.0])
def test_dead_peer_maps_to_peer_abort(monkeypatch, timeout):
    """Under the recovery plane's watcher (armed or not), the wait that
    finds a peer gone raises PeerAbortError for op ``ring_allreduce``,
    well inside the deadline."""
    monkeypatch.setattr(recovery, "_world", lambda: 2)
    monkeypatch.setattr(recovery, "_rank", lambda: 0)
    monkeypatch.setattr(ring_kernel, "_LIVENESS_S", 0.0)
    set_config(collective_timeout=timeout)
    pid = _gone_pid()
    t0 = time.monotonic()
    with pytest.raises(recovery.PeerAbortError) as info:
        recovery.guarded_dispatch("ring_allreduce", "data",
                                  lambda: ring_kernel._await_call(_Event(None), {1: pid}))
    assert time.monotonic() - t0 < 10.0
    assert info.value.op == "ring_allreduce" and info.value.axis == "data"
    assert recovery.stats()["peer_aborts"] == 1
