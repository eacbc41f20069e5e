"""jamie_tpu_torch.evaluation against jamie_tpu.evaluation on the CPU, on
the same embeddings (the port's distances come from K3's plain version)."""

import numpy as np
import pytest

from jamie_tpu import evaluation as jev
from jamie_tpu_torch import evaluation as tev


@pytest.fixture(scope='module')
def embeddings():
    rng = np.random.RandomState(7)
    a = rng.randn(90, 8).astype(np.float32)
    b = (a + 0.4 * rng.randn(90, 8)).astype(np.float32)
    labels = rng.randint(0, 3, 90)
    return [a, b], [labels, labels]


def _euclid(x):
    return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))


@pytest.mark.parametrize('metric', [None, _euclid])
def test_foscttm_matches(embeddings, metric):
    data, _ = embeddings
    ours = tev.test_closer(data, distance_metric=metric, device='cpu')
    assert ours == pytest.approx(jev.test_closer(data, distance_metric=metric),
                                 abs=1e-12)


@pytest.mark.parametrize('k', [None, 1, 5])
def test_label_transfer_matches(embeddings, k):
    data, labels = embeddings
    ours = tev.knn_label_transfer_accuracy(data, labels, k=k, device='cpu')
    assert ours == jev.knn_label_transfer_accuracy(data, labels, k=k)
    assert tev.test_LabelTA(data, labels, device='cpu') == \
        jev.test_LabelTA(data, labels)


@pytest.mark.parametrize('metric', [None, _euclid])
def test_label_dist_matches(embeddings, metric):
    data, labels = embeddings
    keys, dist = tev.test_label_dist(data, labels, distance_metric=metric,
                                     verbose=False, device='cpu')
    jkeys, jdist = jev.test_label_dist(data, labels, distance_metric=metric,
                                       verbose=False)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_allclose(dist, np.asarray(jdist), atol=1e-5)


def test_blocked_sizes_raise(monkeypatch, embeddings):
    """Past _FOSCTTM_BLOCK_ENTRIES the metrics no longer raise: they run
    in row blocks (of the 256-row minimum here, one block at N=90) and
    give the values of the default block size."""
    data, labels = embeddings
    whole = (tev.test_closer(data, device='cpu'),
             tev.knn_label_transfer_accuracy(data, labels, device='cpu'))
    monkeypatch.setattr(tev, '_FOSCTTM_BLOCK_ENTRIES', 100)
    assert (tev.test_closer(data, device='cpu'),
            tev.knn_label_transfer_accuracy(data, labels, device='cpu')) \
        == whole


@pytest.fixture(scope='module')
def large_embeddings():
    """600 cells: three 256-row blocks at the minimum block size, the last
    ragged. Rows 0-39 of b repeat a exactly, so their true-match distance
    is 0 and the strict < is decided by the exact diagonal."""
    rng = np.random.RandomState(11)
    a = rng.randn(600, 8).astype(np.float32)
    b = (a + 0.6 * rng.randn(600, 8)).astype(np.float32)
    b[:40] = a[:40]
    labels = rng.randint(0, 4, 600)
    return [a, b], [labels, labels]


def test_blocked_metrics_match(monkeypatch, large_embeddings):
    """The row-blocked FOSCTTM and kNN against jamie_tpu's row-blocked
    route (both with a patched _FOSCTTM_BLOCK_ENTRIES) and against the
    default block size's one block: FOSCTTM's counts are integers, so equal
    to 1e-12; the kNN accuracy is equal."""
    data, labels = large_embeddings
    whole_f = tev.test_closer(data, device='cpu')
    whole_k = tev.knn_label_transfer_accuracy(data, labels, device='cpu')
    for mod in (tev, jev):
        monkeypatch.setattr(mod, '_FOSCTTM_BLOCK_ENTRIES', 1000)
    ours_f = tev.test_closer(data, device='cpu')
    ours_k = tev.knn_label_transfer_accuracy(data, labels, device='cpu')
    assert ours_f == pytest.approx(jev.test_closer(data), abs=1e-12)
    assert ours_f == pytest.approx(whole_f, abs=1e-12)
    assert ours_k == jev.knn_label_transfer_accuracy(data, labels) == whole_k


def test_blocked_foscttm_uses_the_exact_diagonal(monkeypatch):
    """Each block's self-pair entries are the exact sum((a-b)^2), as in
    jamie_tpu: on cells at |x|^2 ~ 1e6, where the Gram formula's rounding
    (~0.06) exceeds the true-match distances (0 and 1e-6), the count
    equals jamie_tpu's."""
    a = np.array([[1e3, 1.0], [1e3, 1.0 + 1e-3]] + [[i, -i] for i in
                                                    range(298)], np.float32)
    b = a.copy()
    b[1] = b[0]
    monkeypatch.setattr(tev, '_FOSCTTM_BLOCK_ENTRIES', 1000)
    monkeypatch.setattr(jev, '_FOSCTTM_BLOCK_ENTRIES', 1000)
    ours = tev.test_closer([a, b], device='cpu')
    assert ours == pytest.approx(jev.test_closer([a, b]), abs=1e-12)


# ------------------------------------------------------- occlusion, sweeps
def _impact_problem(seed, n, w):
    x = np.random.RandomState(seed).randn(n, len(w))
    w = np.asarray(w, float)

    def function(data, idx=None):
        return data @ w

    def perf(logits, true):
        return np.corrcoef(logits, true)[0, 1]
    return x, x @ w, function, perf


def _impact_both(x, y, function, perf, **kw):
    ours = tev.evaluate_impact(function, perf, x, y, **kw)
    ref = jev.evaluate_impact(function, perf, x, y, **kw)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
    return ours


def test_evaluate_impact_host():
    """tests/test_evaluation.py:172-190 in both packages: the dominant
    feature hurts most when occluded; the outputs are equal."""
    w = np.full(6, 0.1)
    w[2] = 5.0
    baseline, performance, _ = _impact_both(*_impact_problem(0, 50, w))
    assert baseline > 0.99
    assert np.argmin(performance) == 2


def test_evaluate_impact_keep_sequential_restores():
    """tests/test_evaluation.py:237-256: keep mode restores its occluded
    columns even under sequential=True."""
    problem = _impact_problem(1, 40, [4.0, 3.0, 2.0, 1.0])
    _, seq, _ = _impact_both(*problem, mode='keep', sequential=True)
    _, plain, _ = _impact_both(*problem, mode='keep', sequential=False)
    np.testing.assert_allclose(seq, plain, atol=1e-12)


@pytest.mark.parametrize('kw', [dict(sequential=True),
                                dict(scan=2, scan_samples=20),
                                dict(idx=[3, 0], mode='keep')])
def test_evaluate_impact_options_match(kw):
    """Sequential replace, the preliminary scan (same np.random draws) and
    an explicit feature list give jamie_tpu's outputs exactly."""
    _, _, idx = _impact_both(*_impact_problem(2, 40, [1.0, 3.0, 0.5, 2.0]),
                             **kw)
    if 'scan' in kw:
        assert len(idx) == 2


def test_partial_draws_the_same_masks(monkeypatch):
    """test_partial's P masks come from np.random.choice, draw for draw as
    in jamie_tpu: with the same seed both packages build the same priors
    (the estimators are replaced by recorders, so nothing is fitted)."""
    import jamie_tpu.estimator as jest
    import jamie_tpu_torch.estimator as test_
    seen = {}

    def recorder(key):
        class Recorder:
            def __init__(self, P, **kwargs):
                seen.setdefault(key, []).append(np.diag(P).copy())

            def fit_transform(self, dataset):
                return dataset

            def test_LabelTA(self, data, types):
                return float(len(types))

            def test_closer(self, data):
                return 0.5
        return Recorder

    monkeypatch.setattr(jest, 'JAMIE', recorder('jax'))
    monkeypatch.setattr(test_, 'JAMIE', recorder('torch'))
    data = [np.zeros((30, 3)), np.zeros((30, 2))]
    types = [np.arange(30) % 3] * 2
    out = {}
    for key, mod in (('jax', jev), ('torch', tev)):
        np.random.seed(4)
        out[key] = mod.test_partial(data, types, fraction_range=(0, .3, 1),
                                    plot=False)
    assert out['jax'][0] == out['torch'][0]
    assert [int(m.sum()) for m in seen['torch']] == [0, 9, 30]
    for a, b in zip(seen['jax'], seen['torch']):
        np.testing.assert_array_equal(a, b)


def test_partial_fits(synthetic_pair):
    """A short real sweep on the CPU, reusing one F (match_result): one
    finite LTA and FOSCTTM per fraction."""
    data, labels = synthetic_pair
    kw = dict(device='cpu', epoch_DNN=10, min_epochs=2, batch_size=64,
              pca_dim=None, use_early_stop=False, dropout=0.0, log_DNN=10_000)
    F = [np.full((120, 120), 1 / 120, np.float32)]
    acc, fr = tev.test_partial(data, labels, fraction_range=(0, 0.5, 1),
                               plot=False, match_result=F, **kw)
    assert list(fr) == [0, 0.5, 1]
    assert len(acc['lta']) == len(acc['foscttm']) == 3
    assert np.isfinite(acc['lta']).all() and np.isfinite(acc['foscttm']).all()
