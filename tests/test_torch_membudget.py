"""The port's route planner against the JAX package's, on the CPU.

Over a grid of shapes and pinned budgets, ``plan_kmeans``, ``plan_pca``
and ``plan_als`` of both packages choose the same route, suggest the
same chunk width and price every candidate the same.  The in-memory
tables are priced at the rows each package's table holds: the port's
``DenseTable`` holds exactly ``n`` (no padding), the JAX table
``bucket_rows(n, 256)``, so the JAX planner is held to the port's
padding by swapping its ``_padded_rows`` (and at bucket-aligned row
counts, where the two paddings agree, with no swap).  The per-row
price the calibration reads is the JAX package's for K-Means and PCA
and absent for ALS, which the port does not calibrate.  Also the budget
grammar, ``scale_policy``'s checks and modes, and the calibration.
"""

import numpy as np
import pytest

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.utils import membudget as jax_mb
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.data import prefetch
from oap_mllib_tpu_torch.utils import membudget as mb

BUDGETS = [("", ""), ("0", "0"), ("64M", ""), ("1G", "2G"), ("300M", "100M"), ("16G", "")]


@pytest.fixture(autouse=True)
def _fresh_config():
    port_config.reset_config()
    mb.reset_calibration()
    jax_mb.reset_calibration()
    yield
    port_config.reset_config()
    mb.reset_calibration()


def _pin(hbm, host, policy="auto"):
    port_config.set_config(memory_budget_hbm=hbm, memory_budget_host=host, scale_policy=policy)
    jax_set_config(memory_budget_hbm=hbm, memory_budget_host=host, scale_policy=policy)


def _same_plan(got, ref):
    g, r = got.as_dict(), ref.as_dict()
    for key in ("route", "natural", "policy", "estimates", "chunk_rows", "over_budget",
                "forced", "degraded_scale"):
        assert g.get(key) == r.get(key), key
    assert {k: v for k, v in g["budgets"].items() if k != "hbm_detected_as"} == r["budgets"]
    # the port leaves ALS out of the calibration (no per-row price)
    assert got.est_row_bytes == (0 if got.algo == "ALS" else ref.est_row_bytes)


@pytest.fixture
def port_padding(monkeypatch):
    monkeypatch.setattr(jax_mb, "_padded_rows", mb._padded_rows)


class TestPlansMatchJax:
    @pytest.mark.parametrize("hbm,host", BUDGETS)
    def test_kmeans(self, hbm, host, port_padding):
        _pin(hbm, host)
        for n, d, k in ((1000, 8, 4), (1 << 20, 256, 1000), (3 << 20, 128, 64),
                        (50_000_000, 64, 16)):
            hint = 1 if n * k <= (1 << 25) else 4
            _same_plan(mb.plan_kmeans(n, d, k, row_chunks_hint=hint),
                       jax_mb.plan_kmeans(n, d, k, row_chunks_hint=hint))
            for backing in ("memory", "disk", "stream"):
                _same_plan(mb.plan_kmeans(n, d, k, source_backing=backing, chunk_rows=4096),
                           jax_mb.plan_kmeans(n, d, k, source_backing=backing,
                                              chunk_rows=4096))
        _same_plan(mb.plan_kmeans(None, 16, 8, source_backing="stream"),
                   jax_mb.plan_kmeans(None, 16, 8, source_backing="stream"))

    @pytest.mark.parametrize("hbm,host", BUDGETS)
    def test_pca(self, hbm, host, port_padding):
        _pin(hbm, host)
        for n, d in ((1000, 8), (1 << 20, 128), (1 << 27, 256), (300_000, 1024)):
            _same_plan(mb.plan_pca(n, d), jax_mb.plan_pca(n, d))
            _same_plan(mb.plan_pca(n, d, source_backing="disk", chunk_rows=8192),
                       jax_mb.plan_pca(n, d, source_backing="disk", chunk_rows=8192))

    @pytest.mark.parametrize("hbm,host", BUDGETS)
    def test_als(self, hbm, host):
        _pin(hbm, host)
        for nnz, nu, ni, r in ((2500, 157, 83, 6), (25_000_095, 162_541, 59_047, 10),
                               (25_000_095, 162_541, 59_047, 32), (10 ** 9, 10 ** 7, 10 ** 6, 16)):
            for world in (1, 4):
                for backing in (None, "memory"):
                    _same_plan(mb.plan_als(nnz, nu, ni, r, world=world, source_backing=backing),
                               jax_mb.plan_als(nnz, nu, ni, r, world=world,
                                               source_backing=backing))

    @pytest.mark.parametrize("n", [256, 1024, 1 << 20])
    def test_bucket_aligned_rows_need_no_swap(self, n):
        _pin("64M", "")
        _same_plan(mb.plan_kmeans(n, 32, 8), jax_mb.plan_kmeans(n, 32, 8))
        _same_plan(mb.plan_pca(n, 32), jax_mb.plan_pca(n, 32))

    def test_chunk_rows_shrink_with_the_budget(self):
        for hbm in ("1M", "8M", "64M", "1G"):
            _pin(hbm, "")
            for d, extra in ((256, 1000), (128, 0), (3, 2)):
                b = mb.Budgets.resolve()
                assert (mb.suggest_chunk_rows(d, extra, b, 1 << 16)
                        == jax_mb.suggest_chunk_rows(d, extra, jax_mb.Budgets.resolve(), 1 << 16))


class TestPolicy:
    def test_parse_budget_equals_jax(self):
        for spec in ("", "  ", "0", "unlimited", "none", "inf", "4G", "512m", "1.5k",
                     "1073741824", "2T"):
            assert mb.parse_budget(spec) == jax_mb.parse_budget(spec)
        for bad in ("lots", "4Q", "-1", "G"):
            with pytest.raises(ValueError, match="budget"):
                mb.parse_budget(bad)
            with pytest.raises(ValueError):
                jax_mb.parse_budget(bad)

    def test_scale_policy_is_checked(self):
        for policy, want in (("auto", ("auto", None)), ("strict", ("strict", None)),
                             ("pin:streamed", ("pin", "streamed"))):
            port_config.set_config(scale_policy=policy)
            assert mb.scale_policy_cfg() == want
        for bad in ("fast", "pin:disk", "pin:"):
            port_config.set_config(scale_policy=bad)
            with pytest.raises(ValueError, match="scale_policy"):
                mb.scale_policy_cfg()
            with pytest.raises(ValueError, match="scale_policy"):
                mb.plan_pca(1000, 8)

    def test_strict_pin_and_over_budget(self, port_padding):
        _pin("1M", "", "strict")
        with pytest.raises(mb.BudgetError, match="strict") as e:
            mb.plan_kmeans(1 << 20, 256, 1000)
        with pytest.raises(jax_mb.BudgetError):
            jax_mb.plan_kmeans(1 << 20, 256, 1000)
        assert [x.route for x in e.value.estimates] == ["in-memory", "chunked", "streamed"]
        _pin("1M", "", "pin:in-memory")
        plan = mb.plan_pca(1 << 20, 128)
        assert plan.route == "in-memory" and plan.forced and not plan.degraded_scale
        with pytest.raises(ValueError, match="does not apply"):
            mb.plan_pca(1 << 20, 128, source_backing="disk")
        _pin("1K", "")
        plan = mb.plan_pca(1 << 20, 128)
        ref = jax_mb.plan_pca(1 << 20, 128)
        assert plan.over_budget and ref.over_budget and plan.route == "streamed"

    def test_downgrade_is_on_the_record(self):
        _pin("1G", "", "auto")
        plan = mb.plan_als(10 ** 8, 1000, 1000, 8, source_backing="memory")
        assert plan.route == "streamed"
        plan.downgrade("in-memory", "guard")
        assert plan.as_dict()["downgrades"] == ["streamed->in-memory: guard"]
        port_config.set_config(scale_policy="strict")
        plan = mb.plan_als(1000, 10, 10, 2, source_backing="memory")
        with pytest.raises(mb.BudgetError, match="downgrading"):
            plan.downgrade("in-memory", "guard")

    def test_cpu_detects_no_card_budget(self):
        b = mb.Budgets.resolve("cpu")
        assert b.hbm == 0 and b.hbm_source == "detected"
        assert b.as_dict()["hbm_detected_as"] == mb.HBM_DETECTED_AS
        assert mb.detect_hbm_bytes("cpu") == 0


class TestCalibration:
    def test_record_plan_reads_the_staged_bytes(self):
        _pin("64M", "")
        plan = mb.plan_kmeans(10_000, 15, 4, source_backing="memory", chunk_rows=1024)
        stats = prefetch.PrefetchStats()
        stats.bytes_staged, stats.rows = 10 * 1024 * 16 * 4 * 2, 10 * 1024
        stats.finalize(None, "lloyd_loop", 0.0)
        summary = {}
        mb.record_plan(summary, plan)
        route = summary["route"]
        assert route["route"] == "streamed" and route["actual_bytes_staged"] == 10 * 1024 * 128
        assert route["staged_bytes_per_row"] == 128.0
        assert route["estimated_bytes_per_row"] == 64.0
        # the ratio (2.0) moves the moving average by 0.3 of the way
        assert route["calibration"] == pytest.approx(1.3)
        assert mb.calibration_factor("kmeans") == pytest.approx(1.3)
        again = mb.plan_kmeans(10_000, 15, 4, source_backing="memory", chunk_rows=1024)
        assert again.estimates[0].hbm_bytes == int(plan.estimates[0].hbm_bytes * 1.3) or (
            abs(again.estimates[0].hbm_bytes - plan.estimates[0].hbm_bytes * 1.3) <= 2)

    def test_ratio_is_clamped(self):
        assert mb._note_calibration("x", 1.0, 100.0) == pytest.approx(1.0 + 0.3 * 3.0)
        assert mb._note_calibration("y", 0.0, 5.0) == 1.0
        assert np.isclose(mb._note_calibration("z", 4.0, 1.0), 1.0 + 0.3 * (0.25 - 1.0))

    def test_als_fits_leave_the_calibration_alone(self):
        """A streamed ALS fit stages group rows, whose width no per-row
        price foresees: its plan records the bytes staged and moves no
        calibration, so a later plan prices the streamed route as the
        first did."""
        from oap_mllib_tpu_torch import ALS

        rng = np.random.default_rng(3)
        users, items = rng.integers(60, size=1500), rng.integers(40, size=1500)
        ratings = (rng.random(1500) * 4 + 1).astype(np.float32)
        first = mb.plan_als(1500, 60, 40, 3)
        _pin("1M", "")
        model = ALS(rank=3, max_iter=2, implicit_prefs=True, device="cpu").fit(
            users, items, ratings, 60, 40)
        route = model.summary["route"]
        assert route["route"] == "streamed" and route["actual_bytes_staged"] > 0
        assert "calibration" not in route and mb.calibration_factor("als") == 1.0
        _pin("", "")
        assert mb.plan_als(1500, 60, 40, 3).as_dict() == first.as_dict()
