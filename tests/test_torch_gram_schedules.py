"""The arithmetic of the PCA moments kernel's tensor-core Gram at the
highest tier, emulated on the CPU (tests/torch_gram_schedules.py).

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there).  These tests hold what a CPU can check: the
three-part bf16 split adds back to every finite f32 value bf16's grid can
hold, the emulated Gram is bit-symmetric and within the tier's 1e-5 of
the plain version and of the JAX package's Pallas kernel (interpret
mode), and the two accumulators with their restarts keep it closer to
the float64 Gram than one accumulator over a long slice does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gram_schedules as sched
from oap_mllib_tpu.ops.pallas import pca_kernel as jax_kernel
from oap_mllib_tpu_torch.ops.cuda import _gram, pca_kernel

# the tier's parity tolerance against the plain version and the Pallas
# kernel (tests/test_torch_pca_kernel.py RTOL["highest"])
RTOL = 1e-5
# against the float64 Gram over one long slice: the kernel's design
# within TIGHT, one accumulator never restarted past it
TIGHT = 2e-6
# bf16's least subnormal is 2^-133: no bf16 parts come closer than half
# of it to an f32 value off that grid; from 2^-110 up the split is exact
GRID_ERR = 2.0 ** -134
EXACT_FROM = 2.0 ** -110


def _data(seed, n, d):
    """Correlated rows around a large mean, with a fractional mask that
    zeroes some rows (tests/test_torch_pca_kernel.py's data)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) + 20.0).astype(np.float32)
    mask = (rng.random(n) * 2.0).astype(np.float32)
    mask[rng.random(n) < 0.1] = 0.0
    mean = x.mean(axis=0).astype(np.float32)
    return x, mask, mean


def _close(port, ref, rtol):
    """``rtol`` against the scale of the whole array."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * np.max(np.abs(ref)))


def _from_bits(b):
    return torch.from_numpy(np.asarray(b, np.uint32).view(np.int32)).view(torch.float32)


def _edge_values(kind):
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 1 << 16, size=400, dtype=np.uint32) << 16
    if kind == "zeros":
        v = [0x00000000, 0x80000000]
    elif kind == "largest":
        v = [0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F0000, 0x7F7F8000, 0x7F7F8001, 0x7F7F7FFF, 0x7F7EFFFF]
    elif kind == "bf16_boundaries":
        # a bf16 value and one f32 ulp above it, and one ulp below it
        v = np.concatenate([hi, hi + 1, (hi - 1) & 0xFFFFFFFF])
    elif kind == "midpoints":
        # bf16 rounding ties and one ulp either side
        v = np.concatenate([hi | 0x8000, hi | 0x7FFF, hi | 0x8001])
    else:  # subnormals: on bf16's grid, off it, and the smallest normals
        sub = rng.integers(1, 1 << 23, size=400, dtype=np.uint32)
        v = np.concatenate([sub, sub & 0x7F0000, sub | 0x80000000, [0x00800000, 0x00800001]])
    v = _from_bits(np.asarray(v, np.uint32))
    return v[torch.isfinite(v)]


def _assert_split(v):
    parts = sched.split3(v)
    for p in parts:
        assert torch.all((sched.bits(p) & 0xFFFF) == 0)
    back = (parts[0].double() + parts[1].double()) + parts[2].double()
    exact = v.abs() >= EXACT_FROM
    assert torch.equal(back[exact], v[exact].double())
    assert torch.all((back - v.double()).abs() <= GRID_ERR)
    # below 2^-110 the parts add to a value of bf16's grid
    grid = back[~exact] * 2.0 ** 133
    assert torch.equal(grid, torch.round(grid))


class TestSplit:
    def test_parts_add_back_exactly(self):
        """Three bf16 parts hold all 24 bits of an f32 value over many
        binades and signs: v0 + v1 + v2 == v bit for bit."""
        rng = np.random.default_rng(1)
        v = rng.normal(size=50_000) * np.exp2(rng.integers(-100, 100, size=50_000))
        v = torch.from_numpy(v.astype(np.float32))
        _assert_split(v)
        p0, p1, p2 = sched.split3(v)
        assert torch.equal(p0 + p1 + p2, v)

    @pytest.mark.parametrize("kind", ["zeros", "largest", "bf16_boundaries", "midpoints",
                                      "subnormals"])
    def test_edge_values(self, kind):
        """±0, f32's largest finite values (whose rounding to bf16 would
        overflow: part 0 truncates there), values one ulp either side of
        a bf16 value or a rounding tie, and subnormals: exact from 2^-110
        up, and below it the nearest value of bf16's grid (2^-133 apart)."""
        _assert_split(_edge_values(kind))

    def test_parts_shrink(self):
        """Each part is at most 2^-8 of the one before it (the products
        the kernel drops are ~2^-24 of the Gram)."""
        rng = np.random.default_rng(2)
        v = torch.from_numpy((rng.normal(size=20_000) * np.exp2(
            rng.integers(-60, 60, size=20_000))).astype(np.float32))
        p0, p1, p2 = sched.split3(v)
        assert torch.all(p1.abs() <= p0.abs() * 2.0 ** -8)
        assert torch.all(p2.abs() <= p1.abs() * 2.0 ** -8)

    def test_lead_truncates_only_past_bf16s_largest(self):
        v = _edge_values("largest")
        p0 = sched.split3(v)[0]
        assert torch.all(torch.isfinite(p0))
        small = v.abs() <= sched.BF16_MAX
        assert torch.equal(p0[small], sched.bf16_rn(v[small]))
        assert torch.equal(p0[~small], sched.trunc_bf16(v[~small]))


SHAPES = [(1337, 64), (777, 67), (2001, 140), (513, 300)]


class TestHighestGram:
    @pytest.mark.parametrize("n,d", SHAPES)
    def test_bit_symmetric(self, n, d):
        x, mask, mean = map(torch.from_numpy, _data(n, n, d))
        g = sched.gram(x, mask, mean)
        assert g.shape == (d, d) and torch.equal(g, g.T)

    @pytest.mark.parametrize("n,d", SHAPES)
    def test_within_plain_and_pallas(self, n, d):
        """Within the tier's 1e-5 of ``pca_moments_plain`` at highest and
        of the JAX package's Pallas kernel on correlated, large-mean rows
        with a fractional mask, over ragged rows and tiles."""
        x, mask, mean = _data(n + d, n, d)
        g = sched.gram(*map(torch.from_numpy, (x, mask, mean)))
        plain, _, _ = pca_kernel.pca_moments_plain(*map(torch.from_numpy, (x, mask, mean)),
                                                   mode="highest", need_sums=False)
        ref, _, _ = jax_kernel.pca_moments_pallas(jnp.asarray(x), jnp.asarray(mask),
                                                  jnp.asarray(mean), mode="highest",
                                                  interpret=True)
        _close(g.numpy(), plain.numpy(), RTOL)
        _close(g.numpy(), ref, RTOL)

    def test_slices_are_the_kernels(self):
        """The emulation sums the row slices of ``wgmma_geometry``: the
        same Gram from one slice differs only by f32 folds."""
        x, mask, mean = map(torch.from_numpy, _data(3, 4099, 64))
        _, slices, rows = _gram.wgmma_geometry(4099, 64)
        assert slices > 1 and rows % sched.BK == 0
        _close(sched.gram(x, mask, mean).numpy(),
               sched.gram(x, mask, mean, slice_rows=4099 + 29).numpy(), 1e-6)

    @pytest.mark.parametrize("variant", ["one_never_restarted", "two_never_restarted",
                                         "one_restarted"])
    def test_two_accumulators_and_restarts(self, variant):
        """Over one slice of 16,384 rows the kernel's design (a0 b0 apart
        from the five small products, both restarted every PROMOTE
        stages, folded by IEEE adds) stays within TIGHT of the float64
        Gram.  The tensor core's sum errs at the scale of what it holds:
        without the restarts that error grows with the slice, past TIGHT
        with one accumulator or two; with restarts but one accumulator,
        the small products round at the large sum's scale and the error
        is larger than the design's."""
        n, d = 1 << 14, 64
        x, mask, mean = map(torch.from_numpy, _data(d, n, d))
        xc = sched.formed(x, mask, mean).double()
        exact = xc.T @ xc
        scale = float(exact.abs().max())

        def err(**kw):
            return float((sched.gram(x, mask, mean, slice_rows=n, **kw).double()
                          - exact).abs().max()) / scale

        design = err()
        assert design <= TIGHT
        if variant == "one_restarted":
            assert err(accumulators=1) > design
        else:
            accs = 1 if variant == "one_never_restarted" else 2
            assert err(accumulators=accs, promote=None) > TIGHT
