"""jamie_tpu_torch.evaluation.kernel_shap against jamie_tpu's: the cases of
tests/test_kernel_shap.py on the same inputs, coalitions and seeds, phi held
to jamie_tpu's within rtol 1e-4 (plus 1e-5 of its largest entry, for
entries near zero) and base values within 1e-5, as well as to each case's
exact answer."""

import numpy as np
import pytest

from jamie_tpu import evaluation as jev
from jamie_tpu_torch.evaluation import ShapValues, kernel_shap, shap_explain


def _linear(W, c):
    return lambda x: np.asarray(x) @ W + c


def _both(predict_fn, data, **kw):
    """The port's (phi, base), after holding it to jamie_tpu's."""
    phi, base = kernel_shap(predict_fn, data, device='cpu', **kw)
    rphi, rbase = jev.kernel_shap(predict_fn, data, **kw)
    assert phi.shape == rphi.shape and base.shape == rbase.shape
    np.testing.assert_allclose(phi, rphi, rtol=1e-4,
                               atol=1e-5 * np.abs(rphi).max())
    np.testing.assert_allclose(base, rbase, rtol=0, atol=1e-5)
    return phi, base


def test_linear_model_exact():
    rng = np.random.RandomState(0)
    F, D, N = 8, 3, 20
    W = rng.randn(F, D).astype(np.float32)
    data = rng.randn(N, F).astype(np.float32)
    phi, base = _both(_linear(W, 1.5), data, n_coalitions=256, seed=1)
    assert phi.shape == (N, F, D)
    bg = data.mean(axis=0)
    expected = (data - bg)[:, :, None] * W[None, :, :]
    np.testing.assert_allclose(phi, expected, rtol=1e-3, atol=1e-3)


def test_efficiency_holds_for_nonlinear_model():
    rng = np.random.RandomState(2)
    F, N = 6, 12
    data = rng.rand(N, F).astype(np.float32)

    def f(x):
        x = np.asarray(x)
        return np.stack([np.sin(x[:, 0]) * x[:, 1] + x[:, 2:].sum(axis=1),
                         (x ** 2).sum(axis=1)], axis=1)

    phi, base = _both(f, data, n_coalitions=200, seed=3)
    np.testing.assert_allclose(phi.sum(axis=1), f(data) - base, rtol=1e-4,
                               atol=1e-4)


def test_feature_subset_conditions_on_rest():
    rng = np.random.RandomState(4)
    F, D, N = 10, 2, 8
    W = rng.randn(F, D).astype(np.float32)
    data = rng.randn(N, F).astype(np.float32)
    sub = np.array([1, 4, 7])
    phi, base = _both(_linear(W, 0.0), data, features=sub, n_coalitions=128,
                      seed=5)
    assert phi.shape == (N, 3, D)
    bg = data.mean(axis=0)
    expected = (data[:, sub] - bg[sub])[:, :, None] * W[sub][None, :, :]
    np.testing.assert_allclose(phi, expected, rtol=1e-3, atol=1e-3)
    x_base = data.copy()
    x_base[:, sub] = bg[sub]
    np.testing.assert_allclose(base, x_base @ W, rtol=1e-4, atol=1e-4)


def test_explain_subset_of_rows_and_background():
    rng = np.random.RandomState(6)
    W = rng.randn(5, 2).astype(np.float32)
    data = rng.randn(30, 5).astype(np.float32)
    rows = np.array([3, 17])
    phi, _ = _both(_linear(W, 0.0), data, explain=rows, n_coalitions=96,
                   seed=7)
    assert phi.shape == (2, 5, 2)
    bg = data.mean(axis=0)
    np.testing.assert_allclose(phi, (data[rows] - bg)[:, :, None] * W[None],
                               rtol=1e-3, atol=1e-3)
    zero = np.zeros(5, np.float32)
    phi0, _ = _both(_linear(W, 0.0), data, explain=rows, background=zero,
                    n_coalitions=96, seed=7)
    np.testing.assert_allclose(phi0, data[rows][:, :, None] * W[None],
                               rtol=1e-3, atol=1e-3)


def test_shap_explain_through_estimator(synthetic_pair):
    """shap_explain falls back to the native kernel_shap without the shap
    package and attributes modal_predict through the preclass and model."""
    from jamie_tpu_torch import JAMIE
    data, _labels = synthetic_pair
    jm = JAMIE(device='cpu', epoch_DNN=200, min_epochs=50, log_DNN=10_000,
               batch_size=64, pca_dim=None, distance_mode='euclidean',
               epoch_pd=100, use_early_stop=False, dropout=0.0)
    jm.fit_transform(dataset=data)
    res = shap_explain(jm, data[0][:6], modality=0, max_evals=96)
    assert isinstance(res, ShapValues)
    phi = res.values
    assert phi.shape == (6, data[0].shape[1], data[1].shape[1])
    assert res.base_values.shape == (6, data[1].shape[1])
    assert len(res) == 6 and res[2].values.shape == phi[2].shape
    assert np.isfinite(phi).all()
    pred = jm.modal_predict(data[0][:6], 0)
    bg = np.tile(data[0][:6].mean(axis=0), (6, 1))
    base = jm.modal_predict(bg, 0)
    np.testing.assert_allclose(phi.sum(axis=1), pred - base, rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(res.base_values, base, rtol=1e-4, atol=1e-4)


def test_underdetermined_coalition_budget_rejected():
    rng = np.random.RandomState(10)
    data = rng.randn(5, 40).astype(np.float32)
    with pytest.raises(ValueError, match='features='):
        kernel_shap(_linear(rng.randn(40, 2).astype(np.float32), 0.0),
                    data, n_coalitions=30, device='cpu')


def test_boolean_feature_mask():
    rng = np.random.RandomState(11)
    F, D = 9, 2
    W = rng.randn(F, D).astype(np.float32)
    data = rng.randn(10, F).astype(np.float32)
    mask = np.zeros(F, bool)
    mask[[2, 5, 8]] = True
    phi, _ = _both(_linear(W, 0.0), data, features=mask, n_coalitions=64,
                   seed=12)
    assert phi.shape == (10, 3, D)
    bg = data.mean(axis=0)
    expected = (data[:, mask] - bg[mask])[:, :, None] * W[mask][None]
    np.testing.assert_allclose(phi, expected, rtol=1e-3, atol=1e-3)


def test_masked_eval_streams_in_batches():
    rng = np.random.RandomState(13)
    F, D = 6, 2
    W = rng.randn(F, D).astype(np.float32)
    data = rng.randn(7, F).astype(np.float32)
    seen = []

    def f(x):
        seen.append(len(x))
        return np.asarray(x) @ W

    phi, _ = _both(f, data, n_coalitions=64, seed=14, batch_rows=50)
    assert max(seen) <= 50
    bg = data.mean(axis=0)
    np.testing.assert_allclose(phi, (data - bg)[:, :, None] * W[None],
                               rtol=1e-3, atol=1e-3)


def test_scalar_output_model():
    rng = np.random.RandomState(15)
    F = 7
    wv = rng.randn(F).astype(np.float32)
    data = rng.randn(9, F).astype(np.float32)
    phi, base = _both(lambda x: np.asarray(x) @ wv, data, n_coalitions=64,
                      seed=16)
    assert phi.shape == (9, F, 1) and base.shape == (9, 1)
    bg = data.mean(axis=0)
    np.testing.assert_allclose(phi[:, :, 0], (data - bg) * wv, rtol=1e-3,
                               atol=1e-3)


def test_coalition_sizes_match_reference():
    """The Shapley-kernel size draw is jamie_tpu's, draw for draw."""
    from jamie_tpu_torch.evaluation import _shapley_kernel_sizes
    ours = _shapley_kernel_sizes(12, 500, np.random.RandomState(3))
    ref = jev._shapley_kernel_sizes(12, 500, np.random.RandomState(3))
    np.testing.assert_array_equal(ours, ref)
    assert ours.min() >= 1 and ours.max() <= 11
