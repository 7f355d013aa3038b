"""The port's out-of-core data layer against the JAX package's, on the
CPU: ``ChunkSource`` (chunks and valid counts of arrays, ``.npy``, CSV,
libsvm and parquet files), the shape buckets, SciPy densification, the
eager readers, and the prefetch pipeline (order at every depth, the
producer's errors, the thread's end).  The data are the same numpy
arrays on both sides, so chunks compare bit for bit.
"""

import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from oap_mllib_tpu.data import bucketing as jax_bucketing
from oap_mllib_tpu.data import io as jax_io
from oap_mllib_tpu.data import sparse as jax_sparse
from oap_mllib_tpu.data.stream import ChunkSource as JaxSource
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.data import bucketing, io, prefetch, sparse
from oap_mllib_tpu_torch.data.prefetch import Prefetcher, PrefetchStats
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.utils.timing import Timings


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    yield
    port_config.reset_config()


def _table(seed, n=1000, d=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.4] = 0.0
    return x


def _same_chunks(a, b):
    got, ref = list(a), list(b)
    assert len(got) == len(ref) > 0
    for (c, v), (rc, rv) in zip(got, ref):
        assert v == rv
        assert c.dtype == rc.dtype and c.shape == rc.shape
        np.testing.assert_array_equal(c, rc)
    assert a.n_rows == b.n_rows and a.chunk_rows == b.chunk_rows


class TestChunkSource:
    @pytest.mark.parametrize("rows", [1, 100, 256, 999, 1000, 4096])
    def test_array_chunks_equal_jax(self, rows):
        x = _table(1)
        _same_chunks(ChunkSource.from_array(x, chunk_rows=rows),
                     JaxSource.from_array(x, chunk_rows=rows))
        src = ChunkSource.from_array(x, chunk_rows=rows)
        np.testing.assert_array_equal(src.to_array(), x)
        _same_chunks(src.with_chunk_rows(64), JaxSource.from_array(x, chunk_rows=64))

    def test_files_equal_jax(self, tmp_path, monkeypatch):
        x = _table(2, n=301, d=5)
        npy = tmp_path / "x.npy"
        np.save(npy, x)
        _same_chunks(ChunkSource.from_npy(str(npy), chunk_rows=64),
                     JaxSource.from_npy(str(npy), chunk_rows=64))
        csv = tmp_path / "x.csv"
        np.savetxt(csv, x, delimiter=",")
        _same_chunks(ChunkSource.from_csv(str(csv), chunk_rows=50),
                     JaxSource.from_csv(str(csv), chunk_rows=50))
        svm = tmp_path / "x.libsvm"
        with open(svm, "w") as f:
            for i, row in enumerate(x):
                toks = " ".join(f"{j + 1}:{float(v)!r}" for j, v in enumerate(row) if v != 0.0)
                f.write(f"{i % 3} {toks}\n")
        _same_chunks(ChunkSource.from_libsvm(str(svm), 5, chunk_rows=70),
                     JaxSource.from_libsvm(str(svm), 5, chunk_rows=70))
        with pytest.raises(ValueError, match="exceeds"):
            list(ChunkSource.from_libsvm(str(svm), 4, chunk_rows=70))
        # the eager readers read what the JAX package's Python parsers read
        monkeypatch.setenv("OAP_MLLIB_TPU_PURE_PYTHON", "1")
        labels, dense = io.read_libsvm(str(svm))
        ref_labels, ref_dense = jax_io.read_libsvm(str(svm))
        np.testing.assert_array_equal(dense, ref_dense)
        np.testing.assert_array_equal(labels, ref_labels)
        np.testing.assert_array_equal(dense, x.astype(np.float64))
        with pytest.raises(ValueError, match="exceeds"):
            io.read_libsvm(str(svm), n_features=4)
        np.testing.assert_array_equal(io.read_csv(str(csv)), jax_io.read_csv(str(csv)))
        ratings = tmp_path / "r.txt"
        ratings.write_text("0::3::4.5\n2::1::1.0\n\n5::0::-1.5\n")
        for got, ref in zip(io.read_ratings(str(ratings)), jax_io.read_ratings(str(ratings))):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)

    def test_parquet_equals_jax_where_pyarrow_is_installed(self, tmp_path):
        pa = pytest.importorskip("pyarrow")
        import pyarrow.parquet as pq

        x = _table(3, n=200, d=4).astype(np.float64)
        path = tmp_path / "x.parquet"
        pq.write_table(pa.table({f"c{j}": x[:, j] for j in range(4)}), path,
                       row_group_size=64)
        assert io.parquet_schema(str(path)) == (200, 4)
        _same_chunks(ChunkSource.from_parquet(str(path), chunk_rows=48),
                     JaxSource.from_parquet(str(path), chunk_rows=48))
        sub = ChunkSource.from_parquet(str(path), chunk_rows=48, columns=["c2", "c0"])
        np.testing.assert_array_equal(sub.to_array(), x[:, [2, 0]])

    def test_a_source_that_changes_between_passes_raises(self):
        x = _table(4, n=300)
        calls = []

        def make():
            calls.append(1)
            yield x[: 300 - 10 * len(calls)]

        src = ChunkSource(make, 7, chunk_rows=128)
        assert sum(v for _, v in src) == 290 and src.n_rows == 290
        with pytest.raises(ValueError, match="deterministic"):
            list(src)

    def test_constructor_checks(self):
        with pytest.raises(ValueError, match="chunk_rows"):
            ChunkSource(lambda: iter([]), 3, chunk_rows=0)
        with pytest.raises(ValueError, match="n_features"):
            ChunkSource(lambda: iter([]), 0)
        with pytest.raises(ValueError, match="2-D"):
            ChunkSource.from_array(np.zeros(5))
        with pytest.raises(ValueError, match="width"):
            list(ChunkSource(lambda: iter([np.zeros((3, 2))]), 3))

    @pytest.mark.parametrize("n,multiple", [
        (0, 1), (1, 1), (1000, 256), (65536, 1), (65537, 1), (777, 8), (5, 3),
        (100_000, 256)])
    def test_bucket_rows_equal_jax(self, n, multiple):
        """The port buckets at the JAX package's default factor, 2."""
        assert bucketing.bucket_rows(n, multiple) == jax_bucketing.bucket_rows(n, multiple)
        assert bucketing.bucket_rows(n, multiple) == jax_bucketing.bucket_rows(n, multiple,
                                                                               2.0)

    def test_bucket_rows_rejects_negative_counts(self):
        with pytest.raises(ValueError, match=">= 0"):
            bucketing.bucket_rows(-1)
        with pytest.raises(ValueError, match=">= 0"):
            jax_bucketing.bucket_rows(-1)


class TestSparse:
    def test_sparse_source_densifies_per_chunk_as_jax(self):
        x = _table(5, n=500, d=9)
        for fmt in ("csr", "csc", "coo"):
            m = sp.csr_matrix(x).asformat(fmt)
            assert sparse.is_sparse(m) and jax_sparse.is_sparse(m)
            _same_chunks(ChunkSource.from_array(m, chunk_rows=128),
                         JaxSource.from_array(m, chunk_rows=128))
        assert not sparse.is_sparse(x) and not sparse.is_sparse(torch.zeros(2))
        ints = sp.csr_matrix(np.eye(4, dtype=np.int32))
        assert ChunkSource.from_array(ints).dtype == np.float64

    def test_densify_into_and_nbytes(self):
        x = _table(6, n=333, d=6)
        m = sp.csr_matrix(x)
        out = np.full((340, 6), 7.0, np.float32)
        sparse.densify_into(out, m, 333, block_rows=50)
        ref = np.full((340, 6), 7.0, np.float32)
        jax_sparse.densify_into(ref, m, 333, block_rows=50)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out[:333], x)
        assert sparse.nbytes(m) == jax_sparse.nbytes(m)


class TestPrefetcher:
    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_order_and_values_at_every_depth(self, depth):
        items = list(range(23))
        stats = PrefetchStats()
        with Prefetcher(items, stage=lambda i: i * i, depth=depth, stats=stats) as pf:
            got = list(pf)
        assert got == [i * i for i in items] and stats.chunks == 23

    @pytest.mark.parametrize("depth", [1, 3])
    def test_device_upload_hands_over_host_and_tensors(self, depth):
        x = _table(7, n=300)
        src = ChunkSource.from_array(x, chunk_rows=64)
        stats = PrefetchStats()

        def stage(item):
            chunk, n_valid = item
            return n_valid, (torch.from_numpy(chunk), np.arange(3))

        with Prefetcher(src, stage=stage, device="cpu", depth=depth, stats=stats) as pf:
            out = list(pf)
        assert [v for v, _ in out] == [64, 64, 64, 64, 44]
        np.testing.assert_array_equal(torch.cat([a for _, (a, _) in out]).numpy()[:300], x)
        assert stats.bytes_staged == 5 * (64 * 7 * 4 + 3 * 8) and stats.rows == 5 * 64
        t = Timings()
        stats.finalize(t, "pass", 1.0)
        assert set(t.subphases("pass")) == {"stage", "transfer", "compute", "stream_wall"}
        assert t.overlap_efficiency("pass") is not None or stats.stage_s == 0.0

    def test_depth_one_runs_inline(self):
        threads = set()
        with Prefetcher(range(4), stage=lambda i: threads.add(threading.get_ident()),
                        depth=1) as pf:
            list(pf)
        assert threads == {threading.get_ident()}

    def test_depth_comes_from_the_config(self):
        port_config.set_config(prefetch_depth=3)
        assert prefetch.resolve_depth() == 3 and Prefetcher([]).depth == 3
        with pytest.raises(ValueError, match="depth"):
            prefetch.resolve_depth(0)

    @pytest.mark.parametrize("depth", [1, 3])
    def test_a_producer_error_reaches_the_consumer(self, depth):
        def gen():
            yield 1
            yield 2
            raise OSError("disk gone")

        seen = []
        with pytest.raises(OSError, match="disk gone"):
            with Prefetcher(gen(), depth=depth) as pf:
                for item in pf:
                    seen.append(item)
        assert seen == [1, 2]

        def bad_stage(i):
            if i == 3:
                raise ValueError("bad chunk")
            return i

        with pytest.raises(ValueError, match="bad chunk"):
            with Prefetcher(range(10), stage=bad_stage, depth=depth) as pf:
                list(pf)

    def test_close_ends_the_producer_thread(self):
        pulled = []

        def gen():
            for i in range(1000):
                pulled.append(i)
                yield i

        before = {t for t in threading.enumerate() if t.name.startswith("oap-mllib-tpu-torch")}
        pf = Prefetcher(gen(), depth=3)
        assert next(pf) == 0
        pf.close()
        alive = {t for t in threading.enumerate()
                 if t.name.startswith("oap-mllib-tpu-torch")} - before
        assert alive == set() and pf.stats.leaked_threads == 0
        # the producer never ran more than depth pulls ahead of the consumer
        assert len(pulled) <= 1 + 3 + 1
        with pytest.raises(StopIteration):
            next(pf)

    def test_staged_totals_add_up(self):
        b0, r0 = prefetch.staged_totals()
        stats = PrefetchStats()
        with Prefetcher([0, 1], stage=lambda i: (i, (torch.zeros((5, 2)),)), device="cpu",
                        stats=stats) as pf:
            list(pf)
        stats.finalize(None, "p", 0.0)
        assert prefetch.staged_totals() == (b0 + 80, r0 + 10)
