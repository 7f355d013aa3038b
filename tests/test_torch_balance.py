"""The port's capability-weighted shards (parallel/balance.py), fleet
rollups (telemetry/fleet.py), capability probe (utils/dispatch.py) and
their config fields, against the JAX package on the CPU; and one gloo
world of two processes driving them end to end.

The planners are pure numpy: on a seeded grid of weights, caps, chunk
counts and worlds the port's answers equal the JAX functions' element
for element, and the controller takes the JAX package's decisions on
the same frame sequences.  The world (this file run as a script with
``--worker``, through tests/test_torch_cluster.py's launcher and
timeouts) pins uneven capabilities and holds a streamed K-Means on
``local_sources`` and a block ALS against the one-process fits, and
drives the straggler controller with a slowed process.
"""

import os
import sys
import time

import numpy as np
import pytest

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.parallel import balance as jax_balance
from oap_mllib_tpu.telemetry import fleet as jax_fleet
from oap_mllib_tpu_torch import KMeans, config as port_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.ops import stream_ops
from oap_mllib_tpu_torch.parallel import balance
from oap_mllib_tpu_torch.telemetry import fleet
from oap_mllib_tpu_torch.utils import dispatch

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _fresh_state():
    port_config.reset_config()
    balance.reset()
    fleet.reset_fit()
    dispatch.reset_probe()
    jax_balance._reset_for_tests()
    jax_fleet._reset_for_tests()
    yield
    port_config.reset_config()
    balance.reset()
    fleet.reset_fit()
    jax_balance._reset_for_tests()
    jax_fleet._reset_for_tests()


def _weights(rng, world, near_equal=False):
    if near_equal:
        return 1.0 + rng.uniform(-0.04, 0.04, size=world)
    return np.exp(rng.normal(scale=0.8, size=world))


def _caps(rng, world, scale):
    """None, or per-process caps with some uncapped (0) entries."""
    if rng.random() < 0.3:
        return None
    caps = rng.integers(1, scale, size=world)
    caps[rng.random(world) < 0.3] = 0
    return [int(c) for c in caps]


GRID = list(range(40))


class TestPlannersMatchJax:
    @pytest.mark.parametrize("seed", GRID)
    def test_apportion_and_extents(self, seed):
        rng = np.random.default_rng(seed)
        world = int(rng.choice([1, 2, 3, 4, 7]))
        w = _weights(rng, world)
        n_rows = int(rng.integers(1, 20_000))
        chunk = int(rng.choice([1, 7, 64, 256, 1000]))
        caps = _caps(rng, world, max(2, n_rows // max(1, world - 1)))
        assert balance.plan_extents(n_rows, chunk, w, caps) == jax_balance.plan_extents(
            n_rows, chunk, w, caps)
        total = int(rng.integers(0, 500))
        capa = None if caps is None else np.asarray(caps, np.float64)
        got, over = balance._apportion(total, w, capa)
        want, jover = jax_balance._apportion(total, w, capa)
        np.testing.assert_array_equal(got, want)
        assert over == jover and int(got.sum()) == total

    @pytest.mark.parametrize("seed", GRID)
    def test_block_offsets(self, seed):
        rng = np.random.default_rng(1000 + seed)
        world = int(rng.choice([1, 2, 3, 4, 8]))
        w = _weights(rng, world, near_equal=seed % 4 == 0)
        n_keys = int(rng.integers(1, 5000))
        caps = _caps(rng, world, max(2, n_keys // max(1, world - 1)))
        got = balance.plan_block_offsets(n_keys, w, caps)
        want = jax_balance.plan_block_offsets(n_keys, w, caps)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
        # the capability world of the processes, each over its mesh slots,
        # with its card budget pricing the keys
        nproc = int(rng.choice([1, 2, 4]))
        frames = np.stack([_weights(rng, nproc, near_equal=seed % 3 == 0),
                           (rng.random(nproc) < 0.5).astype(float),
                           rng.choice([0.0, 1e6, 8e10], size=nproc),
                           rng.choice([0.0, 5e5, 2e11], size=nproc)], 1)
        cw, jcw = balance.fold_world(frames), jax_balance.fold_world(frames)
        np.testing.assert_array_equal(cw.weights, jcw.weights)
        assert cw.origins == jcw.origins and cw.origin == jcw.origin
        np.testing.assert_array_equal(cw.hbm, jcw.hbm)
        np.testing.assert_array_equal(cw.host, jcw.host)
        mesh_world = nproc * int(rng.choice([1, 2, 3]))
        for bpk in (0, 4 * (10 + 11 * 12), 4 * (32 + 33 * 34)):
            got = balance.block_offsets(n_keys, mesh_world, bpk, capworld=cw)
            want = jax_balance.block_offsets(n_keys, mesh_world, bpk, capworld=jcw)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, want)
        for backing in ("memory", "disk"):
            assert balance.host_caps_rows(cw, 48, backing) == jax_balance.host_caps_rows(
                jcw, 48, backing)

    def test_irregular_slots_and_the_deadband_keep_uniform_blocks(self):
        cw = balance.fold_world([[1.0, 1, 0, 0], [0.5, 1, 0, 0]])
        assert balance.block_offsets(100, 3, capworld=cw) is None
        assert balance.plan_block_offsets(100, [1.0, 1.04]) is None
        off = balance.block_offsets(100, 4, capworld=cw)
        np.testing.assert_array_equal(off, jax_balance.block_offsets(
            100, 4, capworld=jax_balance.fold_world([[1.0, 1, 0, 0], [0.5, 1, 0, 0]])))
        assert list(np.diff(off)) == [33, 33, 17, 17]


def _gathered(caps, pinned=(), classes=None, devices=None):
    """A gathered ``(world, 6)`` capability frame: probed ``caps`` (those
    in ``pinned`` pinned), hardware classes and devices (defaults: one
    class, a device each)."""
    world = len(caps)
    return np.stack([np.asarray(caps, np.float64),
                     [1.0 if p in pinned else 0.0 for p in range(world)],
                     np.zeros(world), np.zeros(world),
                     np.zeros(world) if classes is None else np.asarray(classes, np.float64),
                     np.arange(world) if devices is None else np.asarray(devices, np.float64)],
                    1)


class TestEqualHardware:
    """Processes on equal hardware get one capability whatever their
    probes read (the probe's spread between equal cards exceeds the
    deadband): the uniform layout on every run."""

    @pytest.mark.parametrize("seed", range(4))
    def test_noisy_probes_of_equal_hardware_plan_the_uniform_layout(self, seed):
        rng = np.random.default_rng(seed)
        world = int(rng.integers(2, 6))
        caps = 5.0 * (1.0 + rng.uniform(-0.15, 0.15, size=world))
        # a card each, or (an even world, odd seeds) two processes a card
        devices = np.arange(world) // (2 if world % 2 == 0 and seed % 2 else 1)
        cw = balance.fold_world(balance.equal_classes(_gathered(caps, devices=devices)))
        assert cw.weights.tolist() == [1.0] * world and cw.origin == "probe"
        assert balance.block_offsets(1000, 2 * world, capworld=cw) is None
        even, _ = balance.plan_extents(4096, 128, np.ones(world))
        assert balance.plan_extents(4096, 128, cw.weights)[0] == even
        # the raw probes alone would have weighted the world
        assert balance.block_offsets(
            1000, 2 * world, capworld=balance.fold_world(_gathered(caps)[:, :4])) is not None

    def test_different_hardware_keeps_the_gap_between_classes(self):
        frames = balance.equal_classes(_gathered([4.0, 6.0, 1.9, 2.1], classes=[7, 7, 9, 9]))
        assert frames[:, 0].tolist() == [5.0, 5.0, 2.0, 2.0]
        off = balance.block_offsets(700, 4, capworld=balance.fold_world(frames))
        assert off is not None and off[1] - off[0] > off[3] - off[2]

    def test_processes_sharing_a_card_are_a_class_of_their_own(self):
        # two processes time-slice one card, a third has one to itself
        frames = balance.equal_classes(_gathered([2.4, 2.6, 5.0], devices=[3, 3, 4]))
        assert frames[:, 0].tolist() == [2.5, 2.5, 5.0]

    def test_pinned_capabilities_stay_as_pinned(self):
        frames = balance.equal_classes(_gathered([1.0, 0.5, 3.0, 3.4], pinned=(0, 1)))
        assert frames[:, 0].tolist() == [1.0, 0.5, 3.2, 3.2]
        np.testing.assert_array_equal(frames[:, 1], [1, 1, 0, 0])
        assert balance.equal_classes(_gathered([1.0, 0.5], pinned=(0, 1)))[:, 0].tolist() == [
            1.0, 0.5]

    def test_the_frame_shape_is_checked(self):
        with pytest.raises(ValueError, match="world, 6"):
            balance.equal_classes(np.ones((2, 4)))

    def test_hardware_labels_are_exact_and_the_same_in_another_process(self):
        import subprocess

        port_config.set_config(device="cpu,cpu")
        labels = dispatch.hardware_identity()
        assert labels == dispatch.hardware_identity()
        assert all(v == int(v) and 0 <= v < 2 ** 48 for v in labels)
        port_config.set_config(device="cpu")
        assert dispatch.hardware_identity()[0] != labels[0]
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from oap_mllib_tpu_torch import set_config; "
                "from oap_mllib_tpu_torch.utils import dispatch; "
                "set_config(device='cpu,cpu'); "
                "print(repr(dispatch.hardware_identity()))")
        out = subprocess.run([sys.executable, "-c", code, os.path.dirname(HERE)],
                             capture_output=True, text=True, timeout=120, check=True)
        assert out.stdout.strip() == repr(labels)

    def test_one_process_reads_one(self):
        port_config.set_config(device="cpu", capability_sharding="on")
        cw = balance.world_capabilities(1)
        assert cw.weights.tolist() == [1.0] and cw.raw.tolist() == [1.0]
        assert cw.origin == "probe"


def _controller_run(walls_of, passes, phase="lloyd_loop", n_rows=4000, chunk=100,
                    world=3, weights=None):
    """Drive both packages' controllers with the same frames: each pass's
    walls come from ``walls_of(pass, rows per process)``; returns both
    decision lists and final extents."""
    frames_cw = np.stack([np.ones(world) if weights is None else weights,
                          np.ones(world), np.zeros(world), np.zeros(world)], 1)
    cw, jcw = balance.fold_world(frames_cw), jax_balance.fold_world(frames_cw)
    plan = balance.make_plan(n_rows, chunk, world=world, capworld=cw)
    jplan = jax_balance.make_plan(n_rows, chunk, world=world, capworld=jcw)
    got, want = [], []
    for p in range(passes):
        rows = np.asarray([r for _, r in plan.extents()], np.float64)
        assert plan.extents() == jplan.extents()
        frames = np.zeros((world, len(fleet.FRAME_FIELDS)))
        frames[:, 0] = walls_of(p, rows)
        frames[:, fleet.FRAME_FIELDS.index("rows")] = rows
        got.append(balance.observe_pass(phase, frames))
        want.append(jax_balance.observe_pass(phase, frames))
    assert got == want
    assert balance.decisions() == jax_balance.decisions()
    assert plan.extents() == jplan.extents()
    return got, plan


class TestControllerMatchesJax:
    @pytest.fixture(autouse=True)
    def _armed(self):
        port_config.set_config(capability_sharding="on", rebalance_threshold=1.3,
                               rebalance_patience=2)
        jax_set_config(capability_sharding="on", rebalance_threshold=1.3, rebalance_patience=2)

    def test_a_persistent_straggler_replans_after_patience(self):
        speeds = np.asarray([1000.0, 400.0, 1000.0])
        got, plan = _controller_run(lambda p, rows: rows / speeds, 8)
        first = next(i for i, d in enumerate(got) if d is not None)
        assert first == 1  # the second over-threshold pass (patience 2)
        assert got[first]["slowest_rank"] == 1
        rows = [r for _, r in plan.extents()]
        assert rows[1] < rows[0] and sum(rows) == 4000

    def test_a_falling_skew_heals_itself(self):
        got, _ = _controller_run(
            lambda p, rows: np.asarray([1.0, 3.0 * 0.7 ** p + 1.0, 1.0]), 10)
        assert all(d is None for d in got[4:])

    def test_init_passes_never_replan(self):
        got, _ = _controller_run(lambda p, rows: np.asarray([1.0, 5.0, 1.0]), 6,
                                 phase="init_centers")
        assert got == [None] * 6

    def test_the_replan_cap_and_noops(self):
        """Patience 1 and a skew no plan removes: every pass decides, at
        most eight times a fit."""
        port_config.set_config(rebalance_patience=1)
        jax_set_config(rebalance_patience=1)
        rng = np.random.default_rng(3)
        got, _ = _controller_run(lambda p, rows: np.asarray([1.0, 4.0, 1.0])
                                 * (1 + 0.01 * rng.random()), 14, world=3)
        assert sum(d is not None for d in got) == balance._MAX_REPLANS

    def test_below_threshold_and_uneven_start(self):
        """Shares in proportion to the speeds: equal walls, no decision."""
        speeds = 1000.0 * np.asarray([2.0, 1.0, 1.0])
        got, plan = _controller_run(lambda p, rows: rows / speeds, 6, weights=speeds)
        assert [r for _, r in plan.extents()] == [2000, 1000, 1000]
        assert got == [None] * 6


class TestFleetMatchesJax:
    def test_fold_pass_summary_and_trend(self):
        port_config.set_config(fleet_stats="on")
        jax_set_config(fleet_stats="on")
        rng = np.random.default_rng(11)
        for _ in range(7):
            frames = rng.random((3, len(fleet.FRAME_FIELDS))) * 10
            rec, jrec = fleet.fold_pass("lloyd_loop", frames), jax_fleet.fold_pass(
                "lloyd_loop", frames)
            assert rec == jrec
        assert fleet.summary_block() == jax_fleet.summary_block()
        assert fleet.FRAME_FIELDS == jax_fleet.FRAME_FIELDS
        for seed in range(20):
            skews = list(np.random.default_rng(seed).random(seed % 9) * 3)
            assert fleet._trend(skews) == jax_fleet._trend(skews)

    def test_a_fit_carries_fleet_and_balance_blocks(self):
        """One process with both planes armed ("on"): the streamed K-Means
        on its identity view folds a frame a pass and carries both blocks;
        its centers are the plain source's bits."""
        port_config.set_config(fleet_stats="on", capability_sharding="on",
                               rank_capability="1.0")
        x = np.random.default_rng(5).normal(size=(1000, 6)).astype(np.float32)
        kw = dict(k=3, seed=2, init_mode="random", max_iter=4, tol=0.0, device="cpu")
        got = KMeans(**kw).fit(balance.local_sources(x, chunk_rows=128))
        s = got.summary
        assert s.fleet["enabled"] and s.fleet["passes"] == s.num_iter + 1
        assert s.fleet["per_rank_rows"] == [1024 * (s.num_iter + 1)]
        assert s.balance["origin"] == "pinned" and s.balance["extents"] == [[0, 1000]]
        assert s.balance["replans"] == [] and s.balance["passes_observed"] == s.num_iter + 1
        port_config.set_config(fleet_stats="off", capability_sharding="off")
        plain = KMeans(**kw).fit(ChunkSource.from_array(x, chunk_rows=128))
        assert plain.summary.fleet is None and plain.summary.balance is None
        np.testing.assert_array_equal(got.cluster_centers_, plain.cluster_centers_)


class TestBalancedView:
    def _plan(self, n, chunk, weights):
        cw = balance.fold_world(np.stack([weights, np.ones(len(weights)),
                                          np.zeros(len(weights)), np.zeros(len(weights))], 1))
        port_config.set_config(capability_sharding="on")
        return balance.make_plan(n, chunk, world=len(weights), capworld=cw)

    def test_the_identity_plan_is_the_plain_source(self):
        x = np.random.default_rng(1).normal(size=(1000, 5)).astype(np.float32)
        view = balance.local_sources(x, chunk_rows=128)
        plain = ChunkSource.from_array(x, chunk_rows=128)
        for (a, na), (b, nb) in zip(view, plain):
            assert na == nb
            np.testing.assert_array_equal(a, b)
        assert view.n_rows == plain.n_rows == 1000

    def test_extents_partition_the_rows_and_match_jax_views(self):
        x = np.arange(4100 * 3, dtype=np.float32).reshape(4100, 3)
        plan = self._plan(4100, 256, np.asarray([1.0, 0.5, 1.5]))
        jax_set_config(capability_sharding="on")
        jplan = jax_balance.make_plan(4100, 256, world=3, capworld=jax_balance.fold_world(
            np.stack([[1.0, 0.5, 1.5], np.ones(3), np.zeros(3), np.zeros(3)], 1)))
        assert plan.extents() == jplan.extents()
        parts = []
        for r in range(3):
            view = balance.BalancedView(x, plan, 256, rank=r)
            jview = jax_balance.BalancedView(x, jplan, 256, rank=r)
            for (a, na), (b, nb) in zip(view, jview):
                assert na == nb
                np.testing.assert_array_equal(a, b)
            parts.append(view.to_array())
        np.testing.assert_array_equal(np.concatenate(parts), x)
        assert [len(p) for p in parts] == [r for _, r in plan.extents()]

    def test_a_replan_takes_effect_at_the_next_pass_in_lockstep(self):
        x = np.random.default_rng(2).normal(size=(2000, 4)).astype(np.float32)
        w = np.arange(2000, dtype=np.float64)
        plan = self._plan(2000, 128, np.asarray([1.0, 1.0]))
        src, wsrc = balance.local_sources(x, sample_weight=w, chunk_rows=128, plan=plan,
                                          rank=1)
        np.testing.assert_array_equal(src.to_array(), x[1024:])
        plan.set_extents([(0, 1536), (1536, 464)], np.asarray([1.5, 0.5]))
        np.testing.assert_array_equal(src.to_array(), x[1536:])
        np.testing.assert_array_equal(wsrc.to_array().ravel(), w[1536:])
        assert src.n_rows == wsrc.n_rows == 464
        for (_, na), (_, nb) in zip(src, wsrc):
            assert na == nb

    def test_with_chunk_rows_stays_aligned(self):
        x = np.random.default_rng(3).normal(size=(1000, 2)).astype(np.float32)
        plan = self._plan(1000, 256, np.asarray([1.0, 2.0]))
        view = balance.BalancedView(x, plan, 256, rank=1)
        half = view.with_chunk_rows(128)
        assert half.chunk_rows == 128 and half.plan is plan
        np.testing.assert_array_equal(half.to_array(), view.to_array())
        with pytest.raises(ValueError, match="divide"):
            balance.BalancedView(x, self._plan(1000, 96, np.asarray([1.0, 2.0])), 128, rank=1)
        with pytest.raises(ValueError, match="outside plan world"):
            balance.BalancedView(x, plan, 256, rank=2)


class TestConfigAndProbe:
    @pytest.mark.parametrize("field,value,check", [
        ("capability_sharding", "onn", lambda: balance.armed(2)),
        ("fleet_stats", "yes", lambda: fleet.armed(2)),
        ("rebalance_threshold", 1.0, balance.rebalance_threshold_cfg),
        ("rebalance_threshold", 0.5, balance.rebalance_threshold_cfg),
        ("rebalance_patience", 0, balance.rebalance_patience_cfg),
        ("rank_capability", "fast", dispatch.pinned_capability),
        ("rank_capability", "0:-1", dispatch.pinned_capability),
        ("rank_capability", "x:1.0", dispatch.pinned_capability),
        ("rank_capability", "0:1.0,1", dispatch.pinned_capability),
    ])
    def test_a_bad_value_raises(self, field, value, check):
        port_config.set_config(**{field: value})
        with pytest.raises(ValueError):
            check()

    def test_a_typo_raises_at_a_streamed_fit(self):
        port_config.set_config(fleet_stats="sometimes")
        x = np.ones((300, 2), np.float32)
        with pytest.raises(ValueError, match="fleet_stats"):
            KMeans(k=2, init_mode="random", device="cpu").fit(ChunkSource.from_array(x, 128))

    def test_defaults_and_env(self, monkeypatch):
        cfg = port_config.get_config()
        assert (cfg.capability_sharding, cfg.rank_capability, cfg.probe_epoch,
                cfg.rebalance_threshold, cfg.rebalance_patience, cfg.fleet_stats) == (
            "auto", "", 0, 1.5, 3, "auto")
        monkeypatch.setenv("OAP_MLLIB_TPU_REBALANCE_PATIENCE", "5")
        monkeypatch.setenv("OAP_MLLIB_TPU_REBALANCE_THRESHOLD", "2.5")
        port_config.reset_config()
        assert port_config.get_config().rebalance_patience == 5
        assert port_config.get_config().rebalance_threshold == 2.5

    def test_pinned_capability(self):
        port_config.set_config(rank_capability="0.25")
        assert dispatch.rank_capability() == (0.25, "pinned")
        port_config.set_config(rank_capability="0:1.0,1:0.5")
        assert dispatch.pinned_capability() == 1.0
        port_config.set_config(rank_capability="1:0.5")
        assert dispatch.pinned_capability() is None

    def test_the_probe_caches_per_seed_and_epoch(self):
        port_config.set_config(device="cpu")
        a = dispatch.throughput_probe(0)
        assert a > 0 and dispatch.throughput_probe(0) == a
        port_config.set_config(probe_epoch=1)
        assert dispatch.throughput_probe(0) > 0
        assert set(dispatch._probe_cache) == {(0, 0), (0, 1)}
        assert dispatch.rank_capability()[1] == "probe"

    def test_the_probe_defaults_to_the_card(self):
        if dispatch.torch.cuda.is_available():
            pytest.skip("the machine has a card")
        with pytest.raises(RuntimeError, match="cuda"):
            dispatch.throughput_probe(7)

    def test_a_frame_never_probes(self):
        stats = stream_ops.PrefetchStats()
        frame = fleet.local_frame(stats, 0.5)
        assert frame.shape == (len(fleet.FRAME_FIELDS),) and frame[-1] == 0.0
        assert dispatch._probe_cache == {}


# -- one world of two processes ----------------------------------------------------------

ROWS, D, CHUNK, K = 4000, 12, 256, 5
CAPS = "0:1.0,1:0.5"


def _slowed(data, seconds):
    """The test's straggler: a row-sliceable wrapper that sleeps once per
    slice (one slice a chunk through a balanced view)."""

    class Slow:
        shape, ndim, dtype = data.shape, data.ndim, data.dtype

        def __getitem__(self, idx):
            if seconds:
                time.sleep(seconds)
            return data[idx]

    return Slow()


def _init_centers():
    from test_torch_cluster import blobs

    return blobs()[[0, 900, 1800, 2700, 3600]].copy()


def _worker_balance(rank, res):
    """Two processes of one rank each: pinned uneven capabilities on a
    streamed Lloyd loop and K-Means fit over ``local_sources`` and on the
    block ALS (resident and streamed); then equal capabilities, a slowed
    process and the live controller."""
    from oap_mllib_tpu_torch import ALS, set_config
    from test_torch_cluster import ALS_CUT, ALS_KW, als_table, blobs

    x = blobs()
    # the controller stays off until the drill: these shares are pinned
    set_config(rank_capability=CAPS, fleet_stats="off")
    src = balance.local_sources(x, chunk_rows=CHUNK)
    res["extents"] = src.plan.extents()
    stream_ops.begin_fit(src)
    c, it, cost, _ = stream_ops.lloyd_run_streamed(src, _init_centers(), 8, 0.0, device="cpu")
    res["lloyd"] = {"centers": c.numpy().tolist(), "iters": it, "cost": float(cost)}
    km = KMeans(k=K, seed=7, init_mode="random", max_iter=8, tol=0.0).fit(src)
    res["kmeans_balance"] = km.summary.balance
    u, i, r = als_table()
    sl = slice(0, ALS_CUT) if rank == 0 else slice(ALS_CUT, None)
    resident = ALS(implicit_prefs=True, **ALS_KW).fit(u[sl], i[sl], r[sl])
    streamed = ALS(implicit_prefs=True, **ALS_KW).fit(
        ChunkSource.from_array(np.stack([u[sl], i[sl], r[sl]], 1).astype(np.float64), 128))
    res["als"] = {"uf": resident.user_factors_.tolist(), "if": resident.item_factors_.tolist(),
                  "balance": resident.summary["balance"],
                  "streamed_balance": streamed.summary["balance"],
                  "streamed_equal": bool(
                      np.array_equal(streamed.user_factors_, resident.user_factors_)
                      and np.array_equal(streamed.item_factors_, resident.item_factors_))}
    # the drill: equal capabilities, process 1 slowed, the rollups armed
    set_config(rank_capability="1.0", probe_epoch=1, fleet_stats="on",
               rebalance_threshold=1.3, rebalance_patience=2)
    drill = balance.local_sources(_slowed(x, 0.02 if rank == 1 else 0.0), chunk_rows=CHUNK)
    res["drill_start"] = drill.plan.extents()
    m = KMeans(k=K, seed=7, init_mode="random", max_iter=8, tol=0.0).fit(drill)
    res["drill"] = {"balance": m.summary.balance, "fleet": m.summary.fleet}


class TestTwoProcessBalance:
    @pytest.fixture(scope="class")
    def world(self):
        from test_torch_cluster import _launch

        return _launch(2, 1, "balance", script=os.path.join(HERE, "test_torch_balance.py"))[0]

    def test_pinned_capabilities_plan_uneven_extents(self, world):
        want, _ = balance.plan_extents(ROWS, CHUNK, [4 / 3, 2 / 3])
        for res in world.values():
            assert [tuple(e) for e in res["extents"]] == want
        assert want[0][1] > want[1][1]

    def test_the_lloyd_loop_matches_one_process(self, world):
        from test_torch_cluster import blobs

        c, it, cost, _ = stream_ops.lloyd_run_streamed(
            ChunkSource.from_array(blobs(), chunk_rows=CHUNK), _init_centers(), 8, 0.0,
            device="cpu")
        for res in world.values():
            got = res["lloyd"]
            assert got["iters"] == it
            np.testing.assert_allclose(got["centers"], c.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["cost"], float(cost), rtol=1e-5)

    def test_the_balance_blocks_agree(self, world):
        a, b = world[0], world[1]
        assert a["kmeans_balance"] == b["kmeans_balance"]
        assert a["kmeans_balance"]["origin"] == "pinned"
        assert a["kmeans_balance"]["weights"] == [1.3333, 0.6667]
        assert a["als"]["balance"] == b["als"]["balance"]
        assert a["als"]["streamed_balance"] == a["als"]["balance"]

    def test_the_weighted_block_als_matches_one_process(self, world):
        from oap_mllib_tpu_torch import ALS
        from test_torch_cluster import ALS_KW, als_table

        off = world[0]["als"]["balance"]["offsets"]
        assert off is not None and off[1] - off[0] > off[2] - off[1]
        u, i, r = als_table()
        one = ALS(implicit_prefs=True, device="cpu,cpu", **ALS_KW).fit(u, i, r)
        for res in world.values():
            assert res["als"]["streamed_equal"]
            np.testing.assert_allclose(res["als"]["uf"], one.user_factors_, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(res["als"]["if"], one.item_factors_, rtol=1e-5,
                                       atol=1e-5)

    def test_the_controller_replans_a_slowed_process(self, world):
        for res in world.values():
            assert [tuple(e) for e in res["drill_start"]] == [(0, 2048), (2048, 1952)]
            bal = res["drill"]["balance"]
            assert bal["replans"], bal
            first = bal["replans"][0]
            # patience 2: the second over-threshold Lloyd pass at the latest
            assert first["pass"] <= 2 + 1 and first["slowest_rank"] == 1
            assert bal["extents"][1][1] < 1952
            assert res["drill"]["fleet"]["slowest_rank"] == 1
        assert world[0]["drill"] == world[1]["drill"]


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    sys.path.insert(0, HERE)
    from test_torch_cluster import _worker

    _worker(sys.argv[2:], {"balance": _worker_balance})
