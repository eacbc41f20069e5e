"""jamie_tpu_torch.utils against jamie_tpu.utils on the CPU.

Tolerances: `hash_kwargs` byte-equal; `outliers`, `ensure_list`,
`reduce_sample_data`, `sort_by_interest` and the JS distance equal (the
same numpy code; `normalize=True` against sklearn's `preprocessing.scale`,
which jamie_tpu calls, within 1e-12); `predict_knn` within 1e-5 of
sklearn's `KNeighborsRegressor` (and of jamie_tpu's, which is sklearn's)
on data without near-ties; `tune_cm` picks the same weights from the same
draws; the legacy plots' PCA scatter offsets within 1e-5 of jamie_tpu's.
"""

import contextlib
import io

import matplotlib
import numpy as np
import pytest
import scipy.sparse as sp

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from jamie_tpu import utils as ref  # noqa: E402
from jamie_tpu_torch import utils as port  # noqa: E402


@pytest.mark.parametrize('kwargs', [
    {},
    {'output_dim': 32, 'epoch_DNN': 10000, 'pca_dim': [512, 512]},
    {'output_dim': 16, 'loss_weights': [1, 2, 1, 1], 'dropout': 0.3,
     'enable_memory_logging': True, 'pca_dim': (128, None)},
    {'dist_method': 'geodesic', 'batch_size': 256, 'use_f_tilde': False},
])
def test_hash_kwargs_byte_equal(kwargs):
    data = [np.zeros((10, 4)), np.zeros((10, 7)), np.zeros((3, 3))]
    assert port.hash_kwargs(kwargs, 'scGEM', data) == \
        ref.hash_kwargs(kwargs, 'scGEM', data)


def test_outliers_and_small_helpers_equal():
    x = np.random.RandomState(0).standard_cauchy((50, 3))
    for kw in ({}, {'aggregate': True}, {'leniency': 0.5}):
        np.testing.assert_array_equal(port.outliers(x, **kw),
                                      ref.outliers(x, **kw))
    mask, lim = port.outliers(x, return_limits=True)
    mask_r, lim_r = ref.outliers(x, return_limits=True)
    np.testing.assert_array_equal(mask, mask_r)
    for a, b in zip(lim, lim_r):
        np.testing.assert_array_equal(a, b)
    for v in (3, [1, 2], np.arange(4)):
        np.testing.assert_array_equal(port.ensure_list(v), ref.ensure_list(v))
    m = sp.random(30, 20, density=0.3, random_state=1, format='csr')
    assert (port.reduce_sample_data(m, 10, 5)
            != ref.reduce_sample_data(m, 10, 5)).nnz == 0
    assert port.identity(m) is m
    assert port.preclass.__name__ == 'Preprocessor'
    assert port.time_logger.__name__ == 'TimeLogger'


@pytest.mark.parametrize('normalize', [False, True])
def test_jensen_shannon_equal(normalize):
    rng = np.random.RandomState(2)
    pairs = [(rng.randn(200), 2 + 3 * rng.randn(150)),
             (rng.randn(100, 3), rng.rand(80, 3)),
             (np.ones(50), rng.randn(50))]          # a zero-variance sample
    for a, b in pairs:
        got = port.jensen_shannon_from_array([a, b], normalize=normalize)
        want = ref.jensen_shannon_from_array([a, b], normalize=normalize)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_scale_matches_sklearn():
    from sklearn.preprocessing import scale
    rng = np.random.RandomState(3)
    for d in (rng.randn(40), rng.randn(40, 3) * [1, 0, 5],
              rng.randint(0, 5, (30, 2)), np.zeros(7)):
        np.testing.assert_allclose(port._scale(d), scale(d, axis=0),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('sort_type', ['entropy-corr', 'js-mse', 'js', 'mse'])
def test_sort_by_interest_equal(sort_type):
    rng = np.random.RandomState(4)
    true = rng.randn(60, 8)
    pred = true + rng.randn(60, 8) * np.linspace(0.1, 2, 8)
    got = port.sort_by_interest([true, pred], limit=5, sort_type=sort_type)
    want = ref.sort_by_interest([true, pred], limit=5, sort_type=sort_type)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _knn_data():
    rng = np.random.RandomState(5)
    return (rng.randn(50, 6).astype(np.float32),
            rng.randn(50, 3).astype(np.float32),
            rng.randn(9, 6).astype(np.float32))


@pytest.mark.parametrize('with_val', [False, True])
@pytest.mark.parametrize('k', [1, 5])
def test_predict_knn_matches_sklearn(with_val, k):
    from sklearn.neighbors import KNeighborsRegressor
    x, y, val = _knn_data()
    val = val if with_val else None
    want = KNeighborsRegressor(n_neighbors=k).fit(x, y).predict(
        x if val is None else val)
    got = port.predict_knn(x, y, val=val, k=k, device='cpu')
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref.predict_knn(x, y, val=val, k=k),
                               rtol=0, atol=1e-5)
    if val is None and k == 1:      # each row is its own nearest neighbour
        np.testing.assert_allclose(got, y, rtol=0, atol=1e-6)


def test_predict_knn_row_blocks(monkeypatch):
    x, y, val = _knn_data()
    whole = port.predict_knn(x, y, val=val, k=3, device='cpu')
    monkeypatch.setattr(port, '_block_rows', lambda n: 4)
    np.testing.assert_array_equal(
        port.predict_knn(x, y, val=val, k=3, device='cpu'), whole)


class _StubEstimator:
    """tune_cm's view of an estimator: config.replace, fit_transform,
    test_LabelTA (accuracy from the weights, so the search has a winner)."""

    def __init__(self):
        from jamie_tpu_torch.config import JamieConfig
        self.config = JamieConfig()

    def fit_transform(self, dataset):
        return dataset

    def test_LabelTA(self, data, types):
        return float(np.sin(np.sum(self.config.loss_weights)))


def test_tune_cm_equal():
    picks = []
    for mod in (port, ref):
        np.random.seed(6)
        with contextlib.redirect_stdout(io.StringIO()):
            picks.append(mod.tune_cm(_StubEstimator(), [1, 2], None, 4,
                                     num_search=5)[0])
    np.testing.assert_array_equal(*picks)


def _offsets(fig):
    return [np.asarray(c.get_offsets()) for ax in fig.axes
            for c in ax.collections]


@pytest.mark.parametrize('mode', ['PCA', None])
def test_uc_visualize_matches_reference(mode):
    rng = np.random.RandomState(7)
    data = [rng.randn(30, 5).astype(np.float32),
            rng.randn(25, 4).astype(np.float32)]
    integ = [rng.randn(30, 3).astype(np.float32),
             rng.randn(25, 3).astype(np.float32)]
    types = [np.arange(30) % 3, np.arange(25) % 3]
    figs, titles = [], []
    for call in (lambda: port.uc_visualize(data, integ, types, mode,
                                           device='cpu'),
                 lambda: ref.uc_visualize(data, integ, types, mode)):
        plt.close('all')
        call()
        figs.append([_offsets(plt.figure(n)) for n in plt.get_fignums()])
        titles.append([ax.get_title() for n in plt.get_fignums()
                       for ax in plt.figure(n).axes])
    plt.close('all')
    assert titles[0] == titles[1]
    assert titles[0][-1] == 'Integrated Cell Types'
    for got, want in zip(*figs):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize('mode', ['TSNE', 'UMAP'])
def test_embed_2d_nonlinear_modes_run_on_the_port(mode):
    x = np.random.RandomState(8).randn(40, 5).astype(np.float32)
    pts = port._embed_2d(x, mode, device='cpu')
    assert pts.shape == (40, 2) and np.isfinite(pts).all()


def test_visualize_mapping_and_estimator_visualize():
    rng = np.random.RandomState(9)
    m = [rng.randn(20, 4).astype(np.float32),
         rng.randn(20, 4).astype(np.float32)]
    offs = []
    for call in (lambda: port.visualize_mapping(m, device='cpu'),
                 lambda: ref.visualize_mapping(m)):
        plt.close('all')
        call()
        offs.append(_offsets(plt.gcf()))
    for g, w in zip(*offs):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    from jamie_tpu_torch import JAMIE
    plt.close('all')
    JAMIE(device='cpu').Visualize(m, m, mode='PCA')
    assert len(plt.get_fignums()) == 2
    plt.close('all')
