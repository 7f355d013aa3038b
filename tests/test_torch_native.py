"""The port's native host layer against the JAX package's.

- The readers (``data/io.read_*``, the C++ parsers of
  ``csrc/host/io_parse.cpp``) give the arrays and dtypes, or the error,
  of the JAX package's Python path (``OAP_MLLIB_TPU_PURE_PYTHON=1``) on
  every case, the example files among them; where the JAX package's C++
  path disagrees with its own Python path the port's departures are
  pinned.
- The table store's lifecycle, the shuffle prep bit-equal to the JAX
  package's, the probes, the CSR front door, and a build without a
  compiler raising.
"""

from __future__ import annotations

import os
import socket
import warnings

import numpy as np
import pytest
import torch

from oap_mllib_tpu import native as jax_native
from oap_mllib_tpu.data import io as jax_io
from oap_mllib_tpu_torch import get_mesh, native
from oap_mllib_tpu_torch.data import io
from oap_mllib_tpu_torch.data.table import CSRTable
from oap_mllib_tpu_torch.parallel import shuffle
from oap_mllib_tpu_torch.utils.dispatch import resolve_devices

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "data")

RATINGS = {
    "movielens_4_columns": ("1::1193::5::978300760\n1::661::3::978302109\n", "::"),
    "comma_4_columns": ("1,2,3.5,99\n4,5,1,7\n", ","),
    "id_above_2_53": ("9007199254740993::1::2.5\n", "::"),
    "spaces_and_blank_lines": (" 1 :: 2 :: 3 \n\n  \n4::5::6\n", "::"),
    "crlf_and_cr": ("1::2::3\r\n4::5::6\r7::8::9", "::"),
    "nan_inf_exponent": ("1::2::nan\n3::4::-inf\n5::6::1e-3\n", "::"),
    "underscores_and_signs": ("1_0::+2::-3_5.5\n", "::"),
    "negative_ids": ("-1::-2::3\n", "::"),
    "float_id_raises": ("1.5::2::3\n", "::"),
    "two_fields_raise": ("1::2\n", "::"),
    "hex_raises": ("1::2::0x1p3\n", "::"),
    "triple_colon_raises": ("1:::2::3\n", "::"),
}
CSV = {
    "plain": "1,2\n3,4\n",
    "trailing_delimiter_raises": "1,2,\n3,4,\n",
    "inline_comment": "3,4 # x\n5,6\n",
    "comment_and_blank_lines": "# hdr\n1,2\n\n3,4\n",
    "whitespace_line_raises": "1,2\n  \n3,4\n",
    "crlf": "1,2\r\n3,4\r\n",
    "one_column": "1\n2\n3\n",
    "nan_inf_exponent": "nan,inf\n-INF,1e5\n.5,5.\n",
    "wrong_delimiter_raises": "1;2\n3;4\n",
    "ragged_raises": "1,2\n3\n",
    "underscore_raises": "1_0,2\n",
    "empty_file": "",
}
LIBSVM = {
    "plain": ("1 1:2 3:4\n0 2:1\n", None),
    "inline_comment_raises": ("1 1:2 # c\n", None),
    "duplicate_and_unsorted": ("1 3:1 1:2 3:5\n0 4:1 2:2\n", None),
    "index_0_and_negative": ("1 3:2 0:5 -1:4\n0 0:5 3:2 0:7\n", None),
    "crlf_blank_comment": ("# c\n1 1:2\r\n\r\n0 2:3   \r\n", None),
    "n_features": ("1 1:2 5:3\n", 8),
    "n_features_below_an_index_raises": ("1 1:2 5:3\n", 3),
    "label_only": ("1\n2\n", None),
    "float_index_raises": ("1 1.5:2\n", None),
    "two_colons_raise": ("1 1:2:3\n", None),
    "far_negative_index_raises": ("1 -9:4 3:2\n", None),
}


@pytest.fixture
def python_path(monkeypatch):
    """The JAX package's readers on their Python path."""
    monkeypatch.setenv("OAP_MLLIB_TPU_PURE_PYTHON", "1")


def _write(tmp_path, name, text):
    path = tmp_path / name
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


def _outcome(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            out = fn(*args)
        except (ValueError, IndexError, OverflowError) as e:
            return e
    return out if isinstance(out, tuple) else (out,)


def _hold(port, ref, path=None):
    """The port's arrays equal the reference's, dtype and NaN sign
    included, or both raise (the port a ValueError naming ``path``)."""
    if isinstance(ref, Exception):
        assert isinstance(port, ValueError), f"reference raised {ref!r}, the port gave {port}"
        assert path is None or path in str(port)
        return
    assert not isinstance(port, Exception), f"the port raised {port!r}"
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _counts():
    return native.table_count(), native.parse_live()


class TestReaders:
    @pytest.mark.parametrize("case", sorted(RATINGS))
    def test_ratings_as_the_python_path(self, tmp_path, python_path, case):
        text, sep = RATINGS[case]
        path = _write(tmp_path, "r.dat", text)
        before = _counts()
        _hold(_outcome(io.read_ratings, path, sep), _outcome(jax_io.read_ratings, path, sep), path)
        _hold(_outcome(io.read_ratings_plain, path, sep),
              _outcome(jax_io.read_ratings, path, sep))
        assert _counts() == before

    @pytest.mark.parametrize("case", sorted(CSV))
    def test_csv_as_the_python_path(self, tmp_path, python_path, case):
        path = _write(tmp_path, "x.csv", CSV[case])
        before = _counts()
        _hold(_outcome(io.read_csv, path), _outcome(jax_io.read_csv, path), path)
        assert _counts() == before

    @pytest.mark.parametrize("case", sorted(LIBSVM))
    def test_libsvm_as_the_python_path(self, tmp_path, python_path, case):
        text, n_features = LIBSVM[case]
        path = _write(tmp_path, "x.svm", text)
        before = _counts()
        _hold(_outcome(io.read_libsvm, path, n_features),
              _outcome(jax_io.read_libsvm, path, n_features), path)
        assert _counts() == before

    @pytest.mark.parametrize("name,reader", [("sample_kmeans_data.txt", "read_libsvm"),
                                             ("pca_data.csv", "read_csv"),
                                             ("sample_als_ratings.txt", "read_ratings")])
    def test_the_example_files(self, python_path, name, reader):
        path = os.path.join(EXAMPLES, name)
        _hold(_outcome(getattr(io, reader), path), _outcome(getattr(jax_io, reader), path), path)
        _hold(_outcome(getattr(io, f"{reader}_plain"), path),
              _outcome(getattr(jax_io, reader), path))

    def test_a_large_ragged_file_crosses_chunks(self, tmp_path):
        """Past one chunk a thread: the same arrays as the plain reader
        whatever line ends the chunk cuts fall on."""
        rng = np.random.default_rng(0)
        n = 20_000
        u, i = rng.integers(1 << 40, size=n), rng.integers(50_000, size=n)
        r = rng.random(n).astype(np.float32) * 4 + 1
        ends = ("\n", "\r\n", "\n\n", "\r")
        text = "".join(f"{a}::{b}::{c:.9g}::97830{k}{ends[k % 4]}"
                       for k, (a, b, c) in enumerate(zip(u.tolist(), i.tolist(), r.tolist())))
        path = _write(tmp_path, "big.dat", text * 4)  # 3.3 MB: four chunks
        got = io.read_ratings(path)
        ref = io.read_ratings_plain(path)
        _hold(got, ref, path)
        assert got[0][:n].tobytes() == u.tobytes() and got[2][:n].tobytes() == r.tobytes()

    @pytest.mark.parametrize("kind", ["ratings", "csv", "libsvm"])
    def test_a_missing_file_raises_with_its_path(self, tmp_path, kind):
        path = str(tmp_path / "missing.txt")
        before = _counts()
        reader = {"ratings": io.read_ratings, "csv": io.read_csv, "libsvm": io.read_libsvm}[kind]
        with pytest.raises(ValueError, match="missing.txt.*cannot open"):
            reader(path)
        assert _counts() == before

    def test_errors_name_the_line(self, tmp_path):
        path = _write(tmp_path, "x.csv", "1,2\n3,4\n5,x\n")
        with pytest.raises(ValueError, match=r"x.csv: line 3: invalid number 'x'"):
            io.read_csv(path)


class TestDepartures:
    """Where the JAX package's C++ path disagrees with its Python path,
    the port gives the Python path's answer (ROADMAP queue C)."""

    CASES = {
        "movielens_4_columns": ("ratings", "1::1193::5::978300760\n", "::"),
        "id_above_2_53": ("ratings", "9007199254740993::1::2.5\n", "::"),
        "csv_trailing_delimiter": ("csv", "1,2,\n", ","),
        "csv_inline_comment": ("csv", "3,4 # x\n", ","),
        "libsvm_inline_comment": ("libsvm", "1 1:2 # c\n", None),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_the_port_keeps_the_python_path(self, tmp_path, monkeypatch, case):
        kind, text, arg = self.CASES[case]
        path = _write(tmp_path, "f.txt", text)
        port = {"ratings": io.read_ratings, "csv": io.read_csv, "libsvm": io.read_libsvm}[kind]
        jax_reader = {"ratings": jax_io.read_ratings, "csv": jax_io.read_csv,
                      "libsvm": jax_io.read_libsvm}[kind]
        monkeypatch.setenv("OAP_MLLIB_TPU_PURE_PYTHON", "1")
        python = _outcome(jax_reader, path, arg)
        _hold(_outcome(port, path, arg), python, path)
        if jax_native.available():
            monkeypatch.delenv("OAP_MLLIB_TPU_PURE_PYTHON")
            cpp = _outcome(jax_reader, path, arg)
            differs = (isinstance(cpp, Exception) != isinstance(python, Exception)
                       or (not isinstance(cpp, Exception)
                           and any(np.asarray(a).tobytes() != np.asarray(b).tobytes()
                                   for a, b in zip(cpp, python))))
            assert differs, "the JAX package's C++ path now agrees: update ROADMAP queue C"


class TestTableStore:
    def test_lifecycle(self):
        start = native.table_count()
        a = native.table_create(2, 3)
        assert native.table_rows(a) == 0 and native.table_cols(a) == 3
        rows = np.arange(15, dtype=np.float64).reshape(5, 3)
        assert native.table_append(a, rows) == 5  # grows past its capacity of 2
        b = native.table_create(0, 3)
        assert native.table_append(b, rows[:2] + 100) == 2
        assert native.table_merge(a, b) == 7
        assert native.table_rows(b) == -1 and native.table_free(b) == -1  # consumed
        np.testing.assert_array_equal(native.table_copy_out(a),
                                      np.concatenate([rows, rows[:2] + 100]))
        c = native.table_create(4, 2)
        assert native.table_merge(a, c) == -1 and native.table_merge(a, a) == -1
        assert native.table_count() == start + 2
        assert native.table_free(a) == 0 and native.table_free(c) == 0
        assert native.table_count() == start

    def test_bad_handles(self):
        bad = 10 ** 9
        assert native.table_rows(bad) == -1 and native.table_cols(bad) == -1
        assert native.table_free(bad) == -1 and native.table_merge(bad, bad + 1) == -1
        assert native.table_append(bad, np.zeros((1, 2))) == -1
        assert native.table_create(4, 0) == -1 and native.table_create(-1, 2) == -1
        with pytest.raises(ValueError, match="invalid native table handle"):
            native.table_view(bad)

    def test_view_is_zero_copy_into_torch(self):
        h = native.table_create(8, 4)
        try:
            native.table_append(h, np.ones((3, 4)))
            view = native.table_view(h)
            t = torch.from_numpy(view)
            assert t.shape == (3, 4) and t.dtype == torch.float64
            t[1, 2] = 7.0
            assert native.table_copy_out(h)[1, 2] == 7.0 and view[1, 2] == 7.0
            assert t.data_ptr() == view.ctypes.data
        finally:
            native.table_free(h)


def _prep_ratings(seed, n, n_users=97, n_items=31):
    """Ragged ratings with many duplicate (user, item) pairs."""
    rng = np.random.default_rng(seed)
    users = rng.integers(n_users, size=n)
    items = rng.integers(n_items, size=n)
    return users, items, rng.random(n).astype(np.float32)


class TestShufflePrep:
    @pytest.mark.parametrize("n,kpb,blocks", [(0, 5, 3), (1, 1, 1), (777, 13, 8),
                                              (20_011, 25, 4), (140_000, 97, 1)])
    def test_bit_equal_to_the_jax_prep(self, n, kpb, blocks):
        users, items, ratings = _prep_ratings(n, n)
        got = native.shuffle_prep(users, items, ratings, kpb, blocks)
        ref = jax_native.shuffle_prep(users, items, ratings, kpb, blocks)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        block = np.minimum(users // kpb, blocks - 1)
        assert got[4].tobytes() == np.lexsort((items, users, block)).tobytes()

    @pytest.mark.parametrize("kpb,blocks", [(1, 1), (13, 8)])
    def test_perm_alone_is_the_preps(self, kpb, blocks):
        users, items, ratings = _prep_ratings(11, 30_000)
        counts, perm = native.shuffle_perm(users.astype(np.int32), items.astype(np.int32),
                                           kpb, blocks)
        ref = native.shuffle_prep(users, items, ratings, kpb, blocks)
        assert counts.tobytes() == ref[3].tobytes() and perm.tobytes() == ref[4].tobytes()

    @pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float32, np.float64, np.int16])
    def test_gather_is_numpys(self, dtype):
        rng = np.random.default_rng(7)
        a = rng.integers(-1000, 1000, size=200_003).astype(dtype)
        perm = rng.permutation(len(a))
        got = native.gather(a, perm)
        assert got.dtype == a.dtype and got.tobytes() == a[perm].tobytes()
        with pytest.raises(ValueError, match="1-D"):
            native.gather(a.reshape(-1, 1), perm)

    def test_wide_ids_sort_by_comparison(self):
        """Ids whose (user, item) span does not pack into 64 bits."""
        rng = np.random.default_rng(5)
        users = rng.integers(1 << 40, size=3000)
        items = rng.choice([0, 1 << 40, 7], size=3000)
        got = native.shuffle_prep(users, items, np.arange(3000.0), 1 << 38, 5)
        ref = jax_native.shuffle_prep(users, items, np.arange(3000.0), 1 << 38, 5)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    def test_offsets_bit_equal(self):
        users, items, ratings = _prep_ratings(9, 5000)
        offsets = np.array([0, 10, 11, 60, 97])
        got = native.shuffle_prep_offsets(users, items, ratings, offsets)
        ref = jax_native.shuffle_prep_offsets(users, items, ratings, offsets)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    def test_distinct_count(self):
        keys = np.sort(np.random.default_rng(2).integers(50, size=999))
        assert native.distinct_count(keys) == jax_native.distinct_count(keys) == len(set(keys))
        assert native.distinct_count(np.zeros(0, np.int64)) == 0

    @pytest.mark.parametrize("kpb,blocks", [(0, 3), (4, 0), (-1, 2)])
    def test_zero_keys_or_blocks_raise(self, kpb, blocks):
        users, items, ratings = _prep_ratings(3, 10)
        with pytest.raises(ValueError, match="must be > 0"):
            native.shuffle_prep(users, items, ratings, kpb, blocks)

    def test_negative_users_raise_on_the_uniform_layout(self):
        with pytest.raises(ValueError, match="user ids must be >= 0"):
            native.shuffle_prep(np.array([3, -1]), np.array([0, 1]), np.ones(2), 2, 2)


class TestProbes:
    def test_local_ip_is_the_jax_probe(self):
        """The two rules agree on a host whose first interface that is not
        "lo" is up and no loopback."""
        assert native.local_ip() == jax_native.local_ip()

    def test_local_ip_is_on_an_up_interface_that_is_no_loopback(self):
        import fcntl
        import struct

        siocgifflags, siocgifaddr, iff_up, iff_loopback = 0x8913, 0x8915, 0x1, 0x8
        flags_of = {}
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for _, name in socket.if_nameindex():
                req = struct.pack("256s", name.encode()[:15])
                try:
                    addr = socket.inet_ntoa(fcntl.ioctl(s, siocgifaddr, req)[20:24])
                    flags = struct.unpack("H", fcntl.ioctl(s, siocgifflags, req)[16:18])[0]
                except OSError:  # no IPv4 address
                    continue
                flags_of[addr] = flags
        ip = native.local_ip()
        usable = [a for a, f in flags_of.items() if f & iff_up and not f & iff_loopback]
        if not usable:
            assert ip is None
        else:
            assert ip in flags_of and ip in usable

    def test_free_port_binds(self):
        port = native.free_port("127.0.0.1", 23_000, 1000)
        assert port is not None and 23_000 <= port < 24_000
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
        assert native.free_port("not-an-ip") is None


class TestFrontDoor:
    def test_data_exports_are_the_jax_packages(self):
        import oap_mllib_tpu.data as jax_data
        import oap_mllib_tpu_torch.data as port_data

        assert port_data.__all__ == jax_data.__all__
        assert all(hasattr(port_data, name) for name in port_data.__all__)
        assert port_data.read_libsvm is io.read_libsvm

    def test_csr_table_matches_jax(self):
        from oap_mllib_tpu.data.table import CSRTable as JaxCSR

        rng = np.random.default_rng(4)
        rows, cols = rng.integers(9, size=40), rng.integers(6, size=40)
        vals = rng.random(40).astype(np.float32)
        got = CSRTable.from_coo(rows, cols, vals, 9, 6, nnz_padded=64, device="cpu")
        ref = JaxCSR.from_coo(rows, cols, vals, 9, 6, nnz_padded=64)
        for f in ("rows", "cols", "values", "row_offsets"):
            a, b = getattr(got, f), np.asarray(getattr(ref, f))
            assert a.device.type == "cpu" and a.numpy().dtype == b.dtype
            assert a.numpy().tobytes() == b.tobytes()
        assert (got.n_rows, got.n_cols, got.nnz) == (ref.n_rows, ref.n_cols, ref.nnz)
        np.testing.assert_array_equal(got.to_dense(), ref.to_dense())
        with pytest.raises(ValueError, match="row index out of range"):
            CSRTable.from_coo([9], [0], [1.0], 9, 6, device="cpu")

    def test_shuffle_to_blocks_matches_jax(self):
        from oap_mllib_tpu.parallel.mesh import get_mesh as jax_get_mesh
        from oap_mllib_tpu.parallel.shuffle import shuffle_to_blocks as jax_shuffle_to_blocks

        rng = np.random.default_rng(6)
        pairs = rng.choice(53 * 17, size=400, replace=False)
        users, items = pairs // 17, pairs % 17
        ratings = rng.random(400).astype(np.float32)
        mesh = get_mesh(devices=resolve_devices("cpu,cpu,cpu,cpu"))
        got = shuffle.shuffle_to_blocks(users, items, ratings, mesh, 53, 17)
        ref = jax_shuffle_to_blocks(users, items, ratings, jax_get_mesh(n_devices=4), 53, 17)
        np.testing.assert_array_equal(got.block_offsets, ref.block_offsets)
        assert got.n_items == ref.n_items and len(got.blocks) == len(ref.blocks) == 4
        for a, b in zip(got.blocks, ref.blocks):
            for f in ("rows", "cols", "values", "row_offsets"):
                assert getattr(a, f).numpy().tobytes() == np.asarray(getattr(b, f)).tobytes()
            assert (a.n_rows, a.n_cols, a.nnz) == (b.n_rows, b.n_cols, b.nnz)


class TestBuild:
    def test_a_missing_compiler_raises_and_nothing_answers(self, tmp_path, monkeypatch):
        """No Python route: with no compiler and no built library the
        readers raise, naming the compiler."""
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "fresh")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        path = _write(tmp_path, "x.csv", "1,2\n")
        with pytest.raises(RuntimeError, match="compiler.*cannot be built"):
            io.read_csv(path)
        from oap_mllib_tpu_torch.utils import resilience

        with pytest.raises(RuntimeError) as err:
            io.read_ratings(path, ",")
        assert resilience.classify_fault(err.value) is None
        assert not (tmp_path / "fresh").exists() or not list((tmp_path / "fresh").iterdir())
