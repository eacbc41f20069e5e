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
    data, labels = embeddings
    monkeypatch.setattr(tev, '_FOSCTTM_BLOCK_ENTRIES', 100)
    with pytest.raises(NotImplementedError, match='item 13'):
        tev.test_closer(data, device='cpu')
    with pytest.raises(NotImplementedError, match='item 13'):
        tev.knn_label_transfer_accuracy(data, labels, device='cpu')
