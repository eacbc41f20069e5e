"""jamie_tpu_torch.ops.distances against jamie_tpu.ops.distances on the
CPU (the euclidean family through K3's plain version)."""

import numpy as np
import pytest
import scipy.sparse
import torch

import jamie_tpu.nn_funcs as jnn
from jamie_tpu.ops import distances as jd
from jamie_tpu_torch import nn_funcs as tnn
from jamie_tpu_torch.ops import distances as td


def _np(d):
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


@pytest.mark.parametrize('modality', [0, 1])
@pytest.mark.parametrize('mode', ['euclidean', 'l2', 'sqeuclidean',
                                  'geodesic'])
def test_distance_matrix_matches_reference(synthetic_pair, mode, modality):
    x = synthetic_pair[0][modality]
    ref = np.asarray(jd.dataset_distance_matrix(x, mode))
    ours = _np(td.dataset_distance_matrix(x, mode, device='cpu'))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    # f32 Gram arithmetic in two libraries: agree to 1e-4 of the matrix max
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours / scale, ref / scale, atol=1e-4)
    assert (np.diag(ours) == 0).all()


def _two_blobs():
    rng = np.random.RandomState(5)
    a = rng.randn(30, 4)
    b = rng.randn(25, 4) + 50.0   # far apart: the kNN graph stays split
    return np.concatenate([a, b]).astype(np.float32)


def test_geodesic_connect_graph_fallback(monkeypatch):
    x = _two_blobs()
    calls = []
    orig = tnn.connect_graph
    monkeypatch.setattr(tnn, 'connect_graph',
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    ours = td.geodesic_distances(x, kmax=5, device='cpu')
    assert calls, 'the kNN graph should still be split at kmax=5'
    ref = jd.geodesic_distances(x, kmax=5)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours / ref.max(), ref / ref.max(), atol=1e-4)


def test_connect_graph_matches_reference():
    x = _two_blobs()
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    graph = jd._knn_graph(d, 5)
    np.testing.assert_array_equal(tnn.connect_graph(graph, d),
                                  jnn.connect_graph(graph, d))


@pytest.mark.parametrize('mode', ['cosine', 'spearman', 'l1'])
def test_unported_modes_raise(mode):
    """These modes, once refused, are ported (item 12): a device metric, a
    rank metric and a host fallback give jamie_tpu's matrix
    (tests/test_torch_metrics.py holds every mode)."""
    x = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    np.testing.assert_allclose(
        _np(td.dataset_distance_matrix(x, mode, device='cpu')),
        np.asarray(jd.dataset_distance_matrix(x, mode)), rtol=0, atol=1e-6)


def test_sparse_and_oversized_inputs_raise(monkeypatch):
    """Sparse inputs and inputs past _FEATURE_CHUNK_THRESHOLD no longer
    raise (ROADMAP.md item 11 is ported): a CSR source gives its dense
    copy's matrix, and past the threshold the bf16-resident route runs
    (exact here: small integers are exact in bf16). The other metrics take
    a CSR source too (item 12), as its dense copy."""
    eye = np.eye(4, dtype=np.float32)
    np.testing.assert_array_equal(
        td.dataset_distance_matrix(scipy.sparse.csr_matrix(eye), 'euclidean',
                                   device='cpu').numpy(),
        td.dataset_distance_matrix(eye, 'euclidean', device='cpu').numpy())
    np.testing.assert_array_equal(
        td.dataset_distance_matrix(scipy.sparse.csr_matrix(eye), 'cosine',
                                   device='cpu').numpy(),
        td.dataset_distance_matrix(eye, 'cosine', device='cpu').numpy())
    monkeypatch.setattr(td, '_FEATURE_CHUNK_THRESHOLD', 10)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    ref = jd.dataset_distance_matrix(x, 'geodesic')
    np.testing.assert_allclose(
        td.dataset_distance_matrix(x, 'geodesic', device='cpu'), ref,
        rtol=1e-6)
