"""The port's block-parallel ALS (the replicated item layout and the 2-D
layout, a mesh held by one process) against the JAX package's block
route, on the CPU.

The JAX package runs on this suite's 8-device CPU mesh, where an ALS fit
takes its block-parallel route by default (world 8), and world 2 with
``num_user_blocks=2``.  The port runs on eight ``"cpu"`` ranks, its
kernel wrappers taking their plain versions.  Fits are compared in
prediction space (X Y^T): factors are unique only up to an invertible
transform.
"""

import numpy as np
import pytest
import torch

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.ops import als_block as jax_block
from oap_mllib_tpu_torch import ALS, config as port_config, get_mesh
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.ops import als_block, als_ops
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from oap_mllib_tpu_torch.parallel import collective
from oap_mllib_tpu_torch.utils import dispatch

CPU8 = ",".join(["cpu"] * 8)
N_USERS, N_ITEMS = 157, 83


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    collective.reset_census()
    yield
    port_config.reset_config()


def _ratings(seed, nnz=2500, n_users=N_USERS, n_items=N_ITEMS):
    """Ratings in [1, 5) with some non-positive ones, skewed items, and
    the last user without any rating (a zero factor row)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(n_users - 1, size=nnz)
    items = np.minimum(rng.zipf(1.5, size=nnz) - 1, n_items - 1)
    ratings = (rng.random(nnz) * 4 + 1).astype(np.float32)
    ratings[rng.random(nnz) < 0.05] = -1.0
    return users, items, ratings


def _pred(model):
    return model.user_factors_ @ model.item_factors_.T


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestBlockFitMatchesJax:
    @pytest.mark.parametrize("layout", ["grouped", "coo"])
    @pytest.mark.parametrize("implicit", [True, False])
    def test_world_eight(self, layout, implicit):
        """The default config on a device list of eight: the block route,
        eight user blocks, within 1e-5 of the JAX package's block fit."""
        users, items, ratings = _ratings(1)
        kw = dict(rank=6, max_iter=5, reg_param=0.1, implicit_prefs=implicit, alpha=2.0,
                  seed=3)
        port_config.set_config(als_kernel=layout)
        jax_set_config(als_kernel=layout)
        ref = JaxALS(**kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        port = ALS(device=CPU8, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        s = port.summary
        assert ref.summary["block_parallel"] and ref.summary["num_user_blocks"] == 8
        assert s["block_parallel"] and s["num_user_blocks"] == 8
        assert s["als_kernel"] == ref.summary["als_kernel"] == layout
        assert s["item_layout"] == "replicated" and s["mesh"] == {"data": 8, "model": 1}
        assert s["kernels"] == {"als_solve": 0, "als_factor_gram": 0}
        assert set(s["timings"].as_dict()) == {"ratings_shuffle", "table_convert",
                                               "als_iterations"}
        assert port.user_factors_.shape == (N_USERS, 6)
        assert np.all(port.user_factors_[-1] == 0.0)
        assert _rel(_pred(port), _pred(ref)) <= 1e-5
        assert port.device == "cpu"

    def test_num_user_blocks_caps_the_data_axis(self):
        users, items, ratings = _ratings(2)
        kw = dict(rank=5, max_iter=4, implicit_prefs=True, alpha=3.0, seed=1,
                  num_user_blocks=2, num_item_blocks=3)
        ref = JaxALS(**kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        port = ALS(device=CPU8, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        s = port.summary
        assert s["num_user_blocks"] == ref.summary["num_user_blocks"] == 2
        assert s["num_user_blocks_requested"] == 2 and s["num_item_blocks_requested"] == 3
        assert s["mesh"] == {"data": 2, "model": 1}
        assert s["als_kernel"] == ref.summary["als_kernel"]
        assert _rel(_pred(port), _pred(ref)) <= 1e-5

    def test_one_user_block_keeps_the_single_device_route(self):
        users, items, ratings = _ratings(3)
        kw = dict(rank=4, max_iter=3, implicit_prefs=True, alpha=2.0, seed=2)
        one = ALS(device="cpu", **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        capped = ALS(device=CPU8, num_user_blocks=1, **kw).fit(users, items, ratings,
                                                               N_USERS, N_ITEMS)
        assert "block_parallel" not in capped.summary
        assert capped.summary["num_user_blocks"] == 1 and capped.device == "cpu"
        np.testing.assert_array_equal(capped.user_factors_, one.user_factors_)

    def test_given_init_and_zero_iterations(self):
        """``init`` places each block's rows of X; at max_iter 0 the fit
        returns the init, padding rows dropped."""
        users, items, ratings = _ratings(4)
        rng = np.random.default_rng(4)
        init = (rng.normal(size=(N_USERS, 3)).astype(np.float32),
                rng.normal(size=(N_ITEMS, 3)).astype(np.float32))
        zero = ALS(rank=3, max_iter=0, device=CPU8).fit(users, items, ratings, N_USERS,
                                                         N_ITEMS, init=init)
        np.testing.assert_array_equal(zero.user_factors_, init[0])
        np.testing.assert_array_equal(zero.item_factors_, init[1])
        seeded = ALS(rank=3, max_iter=0, seed=7, device=CPU8).fit(users, items, ratings,
                                                                   N_USERS, N_ITEMS)
        np.testing.assert_array_equal(seeded.user_factors_, als_np.init_factors(N_USERS, 3, 7))
        ref = JaxALS(rank=3, max_iter=3, seed=0).fit(users, items, ratings, N_USERS,
                                                     N_ITEMS, init=init)
        port = ALS(rank=3, max_iter=3, seed=0, device=CPU8).fit(users, items, ratings,
                                                                 N_USERS, N_ITEMS, init=init)
        assert _rel(_pred(port), _pred(ref)) <= 1e-5


class TestLayout:
    @pytest.mark.parametrize("world", [2, 3, 8])
    def test_shuffle_blocks_and_local_ids(self, world):
        """Uniform blocks of ceil(n_users / world) ids; every rating lands
        in its user's block with the user id rebased, in input order."""
        users, items, ratings = _ratings(5)
        edges = als_block.prepare_block_inputs(users, items, ratings, world, N_USERS)
        kpb = -(-N_USERS // world)
        np.testing.assert_array_equal(edges.offsets,
                                      np.minimum(np.arange(world + 1) * kpb, N_USERS))
        assert edges.upb == kpb
        block = np.minimum(users // kpb, world - 1)
        for b in range(world):
            sel = block == b
            np.testing.assert_array_equal(edges.users[b], users[sel] - edges.offsets[b])
            np.testing.assert_array_equal(edges.items[b], items[sel])
            np.testing.assert_array_equal(edges.ratings[b], ratings[sel])
            assert edges.users[b].min() >= 0 and edges.users[b].max() < edges.upb

    @pytest.mark.parametrize("seed,world", [(6, 8), (7, 2), (8, 5)])
    def test_guard_prices_as_the_jax_guard(self, seed, world):
        users, items, _ = _ratings(seed)
        got = als_block.block_grouped_guard(users, items, N_USERS, N_ITEMS, world)
        ref = jax_block.block_grouped_guard(users, items, N_USERS, N_ITEMS, world)
        assert got[0] == ref[0] and tuple(got[1]) == tuple(ref[1])
        for blowup in (0.5, 1.0, 2.0):
            assert (als_block.block_grouped_guard(users, items, N_USERS, N_ITEMS, world,
                                                  blowup)[0]
                    == jax_block.block_grouped_guard(users, items, N_USERS, N_ITEMS, world,
                                                     blowup)[0])

    def test_item_layout_rule_matches_jax(self):
        for layout in ("auto", "replicated", "sharded"):
            port_config.set_config(als_item_layout=layout)
            jax_set_config(als_item_layout=layout)
            for n_items, r, world, n_users in ((59_047, 10, 8, 162_541), (4_000_000, 10, 8, 10),
                                               (4_000_000, 10, 1, 10), (400_000, 32, 4, 10 ** 8)):
                assert (als_block.item_layout_sharded(n_items, r, world, n_users)
                        == jax_block.item_layout_sharded(n_items, r, world, n_users))


class TestIteration:
    @pytest.mark.parametrize("implicit", [True, False])
    def test_launches_and_psums_per_iteration(self, implicit):
        """What _block_body implies for the kernels: every iteration each
        of the W ranks solves its users (K3) with the Gram of its Y (K4),
        then every item (K3) with the psum of the W X-block Grams (K4):
        K3 = K4 = 2 W max_iter for implicit feedback, no K4 for explicit.
        The item partials psum as three sums and the Grams as one."""
        users, items, ratings = _ratings(9)
        mesh = get_mesh(devices=dispatch.resolve_devices(CPU8))
        edges = als_block.prepare_block_inputs(users, items, ratings, 8, N_USERS)
        sides = als_block.prepare_grouped_inputs(edges, mesh, N_ITEMS, 4)
        counts = {"solve": 0, "gram": 0}

        def solve(*a):
            counts["solve"] += 1
            return als_kernel.solve_plain(*a)

        def gram(f, mode="highest"):
            counts["gram"] += 1
            return als_kernel.factor_gram_plain(f, mode)

        ranks = als_block.data_ranks(mesh)
        x0 = {q: torch.zeros((edges.upb, 4)) for q in ranks}
        y0 = {q: torch.from_numpy(als_np.init_factors(N_ITEMS, 4, 1)) for q in ranks}
        x, y = als_block.als_block_run_grouped(sides, x0, y0, 3, 0.1, 2.0, mesh,
                                               implicit=implicit, solve=solve, gram=gram)
        assert counts == {"solve": 2 * 8 * 3, "gram": 2 * 8 * 3 if implicit else 0}
        assert collective.emitted("psum", "data") == 3 * ((4 if implicit else 3))
        for q in ranks[1:]:
            assert torch.equal(y[q], y[ranks[0]])
        with pytest.raises(ValueError, match="grouped"):
            als_block.als_block_run(sides, x0, y0, 1, 0.1, 2.0, mesh, implicit=True)

    def test_two_fits_give_the_same_bits(self):
        users, items, ratings = _ratings(10)
        a = ALS(rank=4, max_iter=3, implicit_prefs=True, device=CPU8).fit(
            users, items, ratings, N_USERS, N_ITEMS)
        b = ALS(rank=4, max_iter=3, implicit_prefs=True, device=CPU8).fit(
            users, items, ratings, N_USERS, N_ITEMS)
        np.testing.assert_array_equal(a.user_factors_, b.user_factors_)
        np.testing.assert_array_equal(a.item_factors_, b.item_factors_)

    def test_block_fit_against_the_numpy_oracle(self):
        users, items, ratings = _ratings(11)
        port = ALS(rank=4, max_iter=4, implicit_prefs=True, alpha=5.0, seed=1,
                   device=CPU8).fit(users, items, ratings, N_USERS, N_ITEMS)
        x, y = als_np.als_np(users, items, ratings, N_USERS, N_ITEMS, 4, 4, 0.1, 5.0, True,
                             seed=1)
        assert _rel(_pred(port), x @ y.T) <= 1e-4


class TestRules:
    def test_the_2d_item_layout_raises_naming_the_roadmap(self):
        """The 2-D layout, once refused, now fits: a small sharded fit on
        eight ranks matches the replicated fit (1e-5, prediction space)."""
        users, items, ratings = _ratings(12, nnz=300)
        kw = dict(rank=2, max_iter=4, implicit_prefs=True, alpha=2.0, seed=1)
        port_config.set_config(als_item_layout="sharded")
        sharded = ALS(device=CPU8, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert sharded.summary["item_layout"] == "sharded"
        assert sharded.item_factors_.shape == (N_ITEMS, 2)
        # one device has no item layout: the knob is validated, not used
        one = ALS(device="cpu", **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert one.summary["item_layout"] == "replicated"
        port_config.set_config(als_item_layout="replicated")
        rep = ALS(device=CPU8, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert _rel(_pred(sharded), _pred(rep)) <= 1e-5

    def test_auto_past_the_crossover_raises_too(self, monkeypatch):
        """"auto" past a lowered crossover takes the 2-D layout, as the
        JAX package's does, and matches the replicated fit."""
        users, items, ratings = _ratings(13, nnz=300)
        kw = dict(rank=2, max_iter=4, seed=2)
        monkeypatch.setattr(als_block, "ITEM_SHARD_AUTO_BYTES", 16)
        monkeypatch.setattr(jax_block, "ITEM_SHARD_AUTO_BYTES", 16)
        auto = ALS(device=CPU8, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        ref = JaxALS(**kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert auto.summary["item_layout"] == ref.summary["item_layout"] == "sharded"
        port_config.set_config(als_item_layout="replicated")
        rep = ALS(device=CPU8, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert _rel(_pred(auto), _pred(rep)) <= 1e-5
        assert _rel(_pred(auto), _pred(ref)) <= 1e-5

    def test_bad_knobs_raise(self):
        users, items, ratings = _ratings(14, nnz=300)
        port_config.set_config(als_item_layout="diagonal")
        with pytest.raises(ValueError, match="als_item_layout"):
            ALS(rank=2, device="cpu").fit(users, items, ratings)
        for kw in ({"num_user_blocks": 0}, {"num_item_blocks": 0}):
            with pytest.raises(ValueError, match="blocks"):
                ALS(**kw)

    def test_moments_are_shared_with_the_single_device_route(self):
        """The block route's item partials of one rank are the
        single-device partials of that rank's edges."""
        users, items, ratings = _ratings(15)
        mesh = get_mesh(devices=dispatch.resolve_devices(CPU8))
        edges = als_block.prepare_block_inputs(users, items, ratings, 8, N_USERS)
        sides = als_block.prepare_grouped_inputs(edges, mesh, N_ITEMS, 3)
        x = torch.from_numpy(np.random.default_rng(15).normal(size=(edges.upb, 3))
                             .astype(np.float32))
        q = als_block.data_ranks(mesh)[3]
        got = sides.items[q].partials(x, 2.0, True)
        p_i = als_block._group_sizes(len(users), 8, edges.upb, N_ITEMS)[1]
        ref = als_ops.normal_eq_partials_grouped(
            *als_ops.build_grouped_edges(edges.items[3], edges.users[3], edges.ratings[3],
                                         N_ITEMS, p_i), x, N_ITEMS, 2.0, True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


class TestItemLayout2D:
    @pytest.mark.parametrize("layout", ["grouped", "coo"])
    @pytest.mark.parametrize("implicit", [True, False])
    def test_world_eight_matches_jax_and_the_replicated_fit(self, layout, implicit):
        """``als_item_layout="sharded"`` on eight ranks: within 1e-5 of the
        JAX package's sharded block fit and of the port's replicated fit,
        in prediction space."""
        users, items, ratings = _ratings(16)
        kw = dict(rank=5, max_iter=4, reg_param=0.1, implicit_prefs=implicit, alpha=2.0,
                  seed=4)
        port_config.set_config(als_kernel=layout, als_item_layout="sharded")
        jax_set_config(als_kernel=layout, als_item_layout="sharded")
        ref = JaxALS(**kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        port = ALS(device=CPU8, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        s = port.summary
        assert s["item_layout"] == ref.summary["item_layout"] == "sharded"
        assert s["als_kernel"] == ref.summary["als_kernel"] == layout
        assert s["block_parallel"] and s["mesh"] == {"data": 8, "model": 1}
        assert port.item_factors_.shape == (N_ITEMS, 5)
        assert _rel(_pred(port), _pred(ref)) <= 1e-5
        port_config.set_config(als_item_layout="replicated")
        rep = ALS(device=CPU8, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert _rel(_pred(port), _pred(rep)) <= 1e-5

    @pytest.mark.parametrize("implicit", [True, False])
    def test_launches_gathers_and_psums_per_iteration(self, implicit):
        """What _block_body_2d implies: every iteration each of the W ranks
        solves its users and its items (K3 2 W a iteration) with the psum
        of the W block Grams of the other side (K4 2 W, implicit only);
        two all_gathers a iteration, and two Gram psums (implicit)."""
        users, items, ratings = _ratings(17)
        mesh = get_mesh(devices=dispatch.resolve_devices(CPU8))
        by_user = als_block.prepare_block_inputs(users, items, ratings, 8, N_USERS)
        by_item = als_block.prepare_block_inputs(items, users, ratings, 8, N_ITEMS)
        sides = als_block.prepare_grouped_inputs_2d(by_user, by_item, mesh, 3)
        counts = {"solve": 0, "gram": 0}

        def solve(*a):
            counts["solve"] += 1
            return als_kernel.solve_plain(*a)

        def gram(f, mode="highest"):
            counts["gram"] += 1
            return als_kernel.factor_gram_plain(f, mode)

        ranks = als_block.data_ranks(mesh)
        x0 = {q: torch.zeros((by_user.upb, 3)) for q in ranks}
        y0 = {}
        for b, q in enumerate(ranks):
            lo, hi = by_item.offsets[b], by_item.offsets[b + 1]
            blk = torch.zeros((by_item.upb, 3))
            blk[: hi - lo] = torch.from_numpy(als_np.init_factors_rows(lo, hi, 3, 1))
            y0[q] = blk
        x, y = als_block.als_block_run_grouped_2d(sides, x0, y0, 3, 0.1, 2.0, mesh,
                                                  implicit=implicit, solve=solve, gram=gram)
        assert counts == {"solve": 2 * 8 * 3, "gram": 2 * 8 * 3 if implicit else 0}
        assert collective.emitted("all_gather", "data") == 2 * 3
        assert collective.emitted("psum", "data") == (2 * 3 if implicit else 0)
        # padding rows stay zero, so the psum of block Grams is the Gram
        for b, q in enumerate(ranks):
            real = by_item.offsets[b + 1] - by_item.offsets[b]
            assert torch.all(y[q][real:] == 0.0)
        with pytest.raises(ValueError, match="grouped"):
            als_block.als_block_run_2d(sides, x0, y0, 1, 0.1, 2.0, mesh, implicit=True)
        with pytest.raises(ValueError, match="grouped"):
            als_block.als_block_run_grouped_2d(
                als_block.prepare_coo_inputs_2d(by_user, by_item, mesh, 3), x0, y0, 1, 0.1,
                2.0, mesh, implicit=True)

    @pytest.mark.parametrize("seed,world", [(18, 8), (19, 3)])
    def test_guard_2d_prices_as_the_jax_guard(self, seed, world):
        users, items, _ = _ratings(seed)
        got = als_block.block_grouped_guard_2d(users, items, N_USERS, N_ITEMS, world)
        ref = jax_block.block_grouped_guard_2d(users, items, N_USERS, N_ITEMS, world)
        assert got[0] == ref[0] and tuple(got[1]) == tuple(ref[1])
        for blowup in (0.5, 1.0, 2.0):
            assert (als_block.block_grouped_guard_2d(users, items, N_USERS, N_ITEMS, world,
                                                     blowup)[0]
                    == jax_block.block_grouped_guard_2d(users, items, N_USERS, N_ITEMS,
                                                        world, blowup)[0])
