"""The port's ring allreduce (kernel K5's plain version and schedule)
against the JAX package's ring, on the CPU.

The JAX ring runs as its own tests run it: ``ring_allreduce`` under
``shard_map`` on the 8-device CPU mesh (its ppermute schedule).  The
port's plain ring gets the same per-rank inputs, made with numpy, as
CPU tensors, and must give the same bits on every rank.  The CUDA
kernel cannot run here; its launch plan (``ring_kernel.launch_plan``,
the row offsets every launch reads and writes) is emulated with torch
and held to the plain ring bit for bit, and ``chip_smoke.py`` holds the
kernel itself to the plain ring on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from oap_mllib_tpu.ops.pallas._tiers import LANE as JAX_LANE, pad_to as jax_pad_to
from oap_mllib_tpu.ops.pallas.ring_reduce import ring_allreduce as jax_ring
from oap_mllib_tpu.utils.jax_compat import shard_map
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.ops import kmeans_ops
from oap_mllib_tpu_torch.ops.cuda import ring_kernel
from oap_mllib_tpu_torch.parallel import collective, get_mesh
from torch_ring_fold import emulate_fold

CPU = torch.device("cpu")
# the shapes of the JAX package's ring test, and the K-Means fit's packed
# (k, d / model + 2) buffer
SHAPES = [(13, 37), (3, 5), (8, 256), (1, 1), (40, 130), (1000, 130)]


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    collective.reset_census()
    yield
    port_config.reset_config()


def _inputs(world, rows, cols, seed=0):
    rng = np.random.default_rng(seed + 1000 * world + rows * cols)
    return (rng.normal(size=(world, rows, cols)) * 10.0).astype(np.float32)


def _jax_ring(g, segments):
    world = g.shape[0]
    mesh = jax.make_mesh((world,), ("data",), devices=jax.devices()[:world])
    fn = jax.jit(shard_map(
        lambda b: jax_ring(b[0], "data", world, segments=segments)[None],
        mesh=mesh, in_specs=P("data", None, None), out_specs=P("data", None, None),
        check_vma=False,
    ))
    sharding = NamedSharding(mesh, P("data", None, None))
    return np.asarray(fn(jax.device_put(jnp.asarray(g), sharding)))


class TestPlainRingMatchesJax:
    @pytest.mark.parametrize("segments", [1, 2])
    @pytest.mark.parametrize("rows,cols", SHAPES)
    @pytest.mark.parametrize("world", [2, 4, 8])
    def test_bit_for_bit(self, world, rows, cols, segments):
        g = _inputs(world, rows, cols)
        ref = _jax_ring(g, segments)
        out = ring_kernel.ring_allreduce([torch.from_numpy(a) for a in g], segments)
        for r in range(world):
            assert out[r].shape == (rows, cols)
            assert np.array_equal(out[r].numpy(), ref[r]), f"rank {r} differs"
        np.testing.assert_allclose(out[0].numpy(), g.sum(axis=0), atol=1e-4)

    def test_world_one_is_the_identity_through_psum(self):
        x = torch.from_numpy(_inputs(1, 6, 4)[0])
        out = ring_kernel.ring_allreduce([x], axis="data")
        assert len(out) == 1 and out[0] is x
        assert collective.emitted("psum", "data") == 1
        assert collective.emitted("ring_allreduce", "data") == 1

    def test_inputs_are_left_untouched(self):
        g = _inputs(4, 9, 11)
        parts = [torch.from_numpy(a.copy()) for a in g]
        ring_kernel.ring_allreduce(parts)
        for a, p in zip(g, parts):
            assert np.array_equal(a, p.numpy())

    def test_census_counts_the_schedule(self):
        ring_kernel.ring_allreduce([torch.ones(5, 3)] * 4, axis="data")
        assert collective.emitted("ring_allreduce", "data") == 1
        # two directions x (3 reduce-scatter + 3 all-gather) steps
        assert collective.emitted("ppermute", "data") == 2 * 2 * 3
        assert collective.emitted("psum") == 0


def _emulate_plan(parts, segments, snapshot):
    """The kernel's launches as torch ops: every launch of a step reads
    its neighbours' buffers (as they were before the step when
    ``snapshot``, else as the launches before it left them) and adds into
    or copies over its own."""
    world = len(parts)
    rows, cols = parts[0].shape
    rows_pad, cols_pad = ring_kernel.padded_shape(rows, cols, world, segments)
    bufs = ring_kernel._padded_copies(parts, rows_pad, cols_pad)
    half = cols_pad // 2
    for seg, launches in ring_kernel.launch_plan(world, segments, rows_pad):
        src = [b.clone() for b in bufs] if snapshot else bufs
        for r, left, right, row_cw, row_ccw, add in launches:
            for row, c0, nb in ((row_cw, 0, left), (row_ccw, half, right)):
                own = bufs[r][row:row + seg, c0:c0 + half]
                got = src[nb][row:row + seg, c0:c0 + half]
                own.copy_(own + got if add else got)
    return [b[:rows, :cols] for b in bufs]


class TestKernelLaunchPlan:
    @pytest.mark.parametrize("segments", [1, 2, 3])
    @pytest.mark.parametrize("world", [2, 3, 4, 8])
    def test_plan_equals_the_plain_ring(self, world, segments):
        """Each launch writes a segment its neighbours do not read in the
        same step, so launches in any order within a step (sequential on
        one card, concurrent across cards) give the plain ring's bits."""
        for rows, cols in ((1000, 130), (13, 37)):
            parts = [torch.from_numpy(a) for a in _inputs(world, rows, cols, seed=7)]
            ref = ring_kernel.ring_allreduce_plain(parts, segments)
            for snapshot in (False, True):
                out = _emulate_plan(parts, segments, snapshot)
                assert all(torch.equal(a, b) for a, b in zip(ref, out))

    def test_launch_count_and_geometry(self):
        plan = list(ring_kernel.launch_plan(4, 1, 1000))
        assert len(plan) == 2 * 3 and all(len(launches) == 4 for _, launches in plan)
        seg, launches = plan[0]
        assert seg == 250
        # reduce-scatter step 0: rank 0 pulls segment 3 clockwise, 1 ccw
        assert launches[0] == (0, 3, 1, 750, 250, True)
        assert [add for _, ls in plan for (*_, add) in ls[:1]] == [True] * 3 + [False] * 3

    def test_padded_shape_splits_the_columns_as_jax(self):
        assert ring_kernel.padded_shape(1000, 130, 2) == (1000, 256)
        assert ring_kernel.padded_shape(13, 37, 4, 2) == (16, 256)
        assert ring_kernel.padded_shape(1, 1, 8) == (8, 256)
        assert ring_kernel.padded_shape(40, 300, 2) == (40, 512)


class TestKernelFoldOrder:
    """The kernel folds each element in the order the schedule adds it
    (``fold_order``, derived from ``launch_plan``) and runs no steps; its
    indexing, emulated on the CPU, gives the plain ring's bits."""

    @pytest.mark.parametrize("rows,cols", [(1000, 130), (13, 37), (1, 1)])
    @pytest.mark.parametrize("segments", [1, 2, 3])
    @pytest.mark.parametrize("world", [2, 3, 4, 8, 17, 24])
    def test_fold_equals_the_plain_ring(self, world, segments, rows, cols):
        parts = [torch.from_numpy(a) for a in _inputs(world, rows, cols, seed=11)]
        ref = ring_kernel.ring_allreduce_plain(parts, segments)
        out = emulate_fold(parts, segments)
        for r in range(world):
            assert torch.equal(out[r], ref[r]), f"rank {r} differs"

    @pytest.mark.parametrize("segments", [1, 2, 3])
    @pytest.mark.parametrize("world", [2, 3, 4, 8, 17, 24])
    def test_order_is_the_ring_order(self, world, segments):
        """Clockwise, segment j folds x[j], x[j+1], ...; the other half
        x[j], x[j-1], ...: each chain visits every rank once."""
        rows_pad, _ = ring_kernel.padded_shape(1000, 130, world, segments)
        cw, ccw = ring_kernel.fold_order(world, segments, rows_pad)
        for j in range(world):
            assert cw[j] == tuple((j + t) % world for t in range(world))
            assert ccw[j] == tuple((j - t) % world for t in range(world))

    @pytest.mark.parametrize("world", [2, 17, 24])
    def test_table_holds_pointers_then_order(self, world):
        """The kernel's table: inputs, outputs, then order[dir][segment][t]
        at 2 W + (dir W + segment) W + t, with no bound on the world."""
        rows_pad, _ = ring_kernel.padded_shape(1000, 130, world, 1)
        order, half, seg_rows, seg = ring_kernel._geometry(1000, 130, world, 1)
        ins, outs = [100 + r for r in range(world)], [200 + r for r in range(world)]
        table = ring_kernel.fold_table(ins, outs, order)
        assert table[:world] == ins and table[world:2 * world] == outs
        chains = ring_kernel.fold_order(world, 1, rows_pad)
        for dirn in (0, 1):
            for j in range(world):
                at = 2 * world + (dirn * world + j) * world
                assert tuple(table[at:at + world]) == chains[dirn][j]
        assert len(table) == 2 * world + 2 * world * world
        assert (half, seg_rows, seg) == (128, rows_pad, rows_pad // world)

    @pytest.mark.parametrize("cards", [1, 2, 3, 4])
    @pytest.mark.parametrize("total", [1, 7, 130_000, 16_777_216])
    def test_shares_split_the_elements(self, total, cards):
        """Each card's launch folds a contiguous share, starting on a
        whole 16-byte chunk; the shares cover every element once."""
        shares = ring_kernel._shares(total, cards)
        assert len(shares) == cards and shares[0][0] == 0 and shares[-1][1] == total
        for (lo, hi), (nxt, _) in zip(shares, shares[1:]):
            assert lo <= hi == nxt and lo % 4 == 0

    @pytest.mark.parametrize("segments", [1, 2, 3])
    @pytest.mark.parametrize("world", [2, 4, 8])
    @pytest.mark.parametrize("rows,cols", [(1000, 130), (13, 37), (1, 1), (40, 300),
                                           (65536, 256), (7, 513)])
    def test_padded_shape_is_the_jax_rings(self, rows, cols, world, segments):
        """The fold order reads the row segments and the column halves of
        the padded buffer, so the padding must stay the JAX ring's."""
        rows_pad, cols_pad = ring_kernel.padded_shape(rows, cols, world, segments)
        assert rows_pad == jax_pad_to(max(rows, world * segments), world * segments)
        assert cols_pad == jax_pad_to(max(cols, 2 * JAX_LANE), 2 * JAX_LANE)


class TestWrapperRules:
    def test_rejects_bad_operands(self):
        with pytest.raises(TypeError):
            ring_kernel.ring_allreduce([torch.ones(3, 3, dtype=torch.float64)] * 2)
        with pytest.raises(ValueError, match="shapes"):
            ring_kernel.ring_allreduce([torch.ones(3, 3), torch.ones(3, 4)])
        with pytest.raises(ValueError):
            ring_kernel.ring_allreduce([])

    def test_cpu_takes_the_plain_version_and_counts_no_launch(self):
        ring_kernel.reset_launches()
        ring_kernel.ring_allreduce([torch.ones(4, 4)] * 2)
        assert ring_kernel.LAUNCHES == {"ring_reduce": 0}


class TestRingMode:
    def test_resolution(self):
        mesh = get_mesh(devices=[CPU] * 8, model_parallel=2)
        assert kmeans_ops.ring_enabled(mesh, "data")  # auto, data axis of 4
        port_config.set_config(ring_reduction="off")
        assert not kmeans_ops.ring_enabled(mesh, "data")
        port_config.set_config(ring_reduction="on")
        assert kmeans_ops.ring_enabled(mesh, "data")
        assert not kmeans_ops.ring_enabled(mesh, "data", dtype=torch.float64)
        one_row = get_mesh(devices=[CPU] * 2, model_parallel=2)
        assert not kmeans_ops.ring_enabled(one_row, "data")  # < 2 ranks

    def test_typo_raises(self):
        port_config.set_config(ring_reduction="ring")
        with pytest.raises(ValueError, match="ring_reduction"):
            kmeans_ops.ring_enabled(get_mesh(devices=[CPU] * 8), "data")
