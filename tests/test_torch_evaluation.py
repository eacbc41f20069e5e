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
