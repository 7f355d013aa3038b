"""The port's K-Means labels against the JAX package's, path by path: the
dtype read from the JAX package on the same call, and the values.

The JAX package's dtypes are not uniform: its euclidean scoring program
casts to int32 (an array, or each chunk of a source), while its host path
(cosine, or an input with no rows) returns numpy's argmin, int64.  The
port follows it path by path.
"""

import numpy as np
import pytest

from oap_mllib_tpu.compat import spark as jax_spark
from oap_mllib_tpu.data.stream import ChunkSource as JaxChunkSource
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.serving import batcher as jax_batcher
from oap_mllib_tpu_torch import KMeans, config as port_config
from oap_mllib_tpu_torch.compat import spark as port_spark
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.serving import batcher


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    port_config.set_config(device="cpu")
    yield
    port_config.reset_config()


def _blobs(seed, n=700, d=11, k=5):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * 8.0
    x = (true[rng.integers(k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)
    return x + 20.0  # off the origin, so cosine and euclidean labels differ in kind


def _models(measure, seed=3):
    x = _blobs(seed)
    kw = dict(k=5, max_iter=10, seed=1, init_mode="random", distance_measure=measure)
    return x, KMeans(device="cpu", **kw).fit(x), JaxKMeans(**kw).fit(x)


def _same(port, ref):
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
class TestPredict:
    def test_array(self, measure):
        x, port, ref = _models(measure)
        _same(port.predict(x), ref.predict(x))
        _same(port.transform(x[:17]), ref.transform(x[:17]))

    def test_chunk_source(self, measure):
        x, port, ref = _models(measure)
        _same(port.predict(ChunkSource.from_array(x, chunk_rows=256)),
              ref.predict(JaxChunkSource.from_array(x, chunk_rows=256)))

    def test_no_rows(self, measure):
        x, port, ref = _models(measure)
        empty = np.zeros((0, x.shape[1]), np.float32)
        _same(port.predict(empty), ref.predict(empty))


def test_the_dtypes_are_the_jax_packages():
    """The reference's own dtypes, read here so that a change there shows:
    int32 from the euclidean program, int64 from the host path."""
    x, _, ref = _models("euclidean")
    _, _, ref_cos = _models("cosine")
    assert np.asarray(ref.predict(x)).dtype == np.int32
    assert np.asarray(ref_cos.predict(x)).dtype == np.int64
    assert np.asarray(ref.predict(np.zeros((0, x.shape[1]), np.float32))).dtype == np.int64


def test_serving_assign_kmeans():
    """The serving program on pinned centers, as a served request runs
    it, including a request whose rows pad to a bucket."""
    x, port, ref = _models("euclidean")
    for rows in (x, x[:5], x[:1]):
        _same(batcher.assign_kmeans(port._centers_dev(), rows),
              jax_batcher.assign_kmeans(ref._centers_dev(), rows))


@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
def test_compat_transform_prediction_column(measure):
    x = _blobs(4)
    fits = [mod.KMeans().setK(4).setMaxIter(8).setSeed(2).setInitMode("random")
            .setDistanceMeasure(measure).fit(x) for mod in (port_spark, jax_spark)]
    port, ref = (m.transform(x)["prediction"] for m in fits)
    _same(port, ref)
