"""K4's plain version (`jamie_tpu_torch/ops/shortest_paths.py`, the blocked
Floyd-Warshall's phases in PyTorch) against scipy's all-pairs Dijkstra,
which the host route runs, on the CPU. The kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import shortest_path

from jamie_tpu_torch import nn_funcs
from jamie_tpu_torch.core import timing
from jamie_tpu_torch.ops import distances as td
from jamie_tpu_torch.ops import shortest_paths as K

B = K.TILE


def _euclidean(x):
    return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)


def _blobs(n, rng):
    """Two far-apart blobs of n // 2 and n - n // 2 points."""
    x = rng.randn(n, 3)
    x[: n // 2] += 40.0
    return x


def _graph(kind, n, seed=0):
    """A dense host graph as geodesic_distances builds it (0: no edge)."""
    rng = np.random.RandomState(seed)
    if kind == 'knn':
        return td._knn_graph(_euclidean(rng.randn(n, 3)), min(5, n - 1))
    if kind == 'duplicates':
        # every point twice: zero distances, stored as 0, link nothing
        x = rng.randn(n, 3)[np.arange(n) // 2]
        return td._knn_graph(_euclidean(x), min(3, n - 1))
    d = _euclidean(_blobs(n, rng))
    graph = td._knn_graph(d, min(3, n - 1))
    if kind == 'bridged':
        return nn_funcs.connect_graph(graph, d)
    if kind == 'disconnected':
        return graph
    assert kind == 'asymmetric'
    # each row's own neighbours only, and one pair stored twice with
    # different weights: the smaller direction counts
    graph = np.zeros_like(d)
    idx = np.argsort(d, axis=1)[:, 1:3]
    rows = np.repeat(np.arange(n), idx.shape[1])
    graph[rows, idx.ravel()] = d[rows, idx.ravel()]
    if n > 1:
        graph[0, n - 1], graph[n - 1, 0] = 7.0, 0.25
    return graph


def _dijkstra(graph):
    """The host route: scipy's Dijkstra with the largest finite distance
    in the unreachable pairs."""
    sp = shortest_path(csr_matrix(graph), method='D', directed=False)
    finite = sp[np.isfinite(sp)].max()
    return np.where(np.isinf(sp), finite, sp)


def _padded(graph):
    """The matrix the kernel closes: edges as +inf-padded float64, the
    smaller of two stored directions, 0 on the diagonal."""
    n = graph.shape[0]
    npad = B * K.rounds(n)
    w = np.full((npad, npad), np.inf)
    g = np.where(graph > 0, graph, np.inf).astype(np.float64)
    w[:n, :n] = np.minimum(g, g.T)
    np.fill_diagonal(w, 0.0)
    return torch.as_tensor(w)


@pytest.mark.parametrize('kind', ['knn', 'duplicates', 'bridged',
                                  'disconnected', 'asymmetric'])
@pytest.mark.parametrize('n', [1, 2, B - 1, B, B + 1, 300])
def test_plain_closure_matches_dijkstra(n, kind):
    """The blocked phases in float64 give scipy's float64 path sums up to
    their summation order; the float32 result agrees to float32 rounding."""
    graph = _graph(kind, n)
    want = _dijkstra(graph)
    closed = K.floyd_warshall_plain(_padded(graph))[:n, :n].numpy()
    fin = np.isfinite(closed)
    assert (fin == np.isfinite(shortest_path(csr_matrix(graph),
                                             directed=False))).all()
    np.testing.assert_allclose(closed[fin], want[fin], rtol=1e-13, atol=0)
    got = K.shortest_paths(graph, 'cpu')
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=2 ** -23,
                               atol=0)
    if kind == 'disconnected' and n > 2:
        assert not fin.all() and got.max() == np.float32(want.max())


@pytest.mark.parametrize('tile', [1, 8, 64])
def test_plain_closure_any_tile(tile):
    """The phases hold at any tile that divides n: one vertex a round is
    the textbook Floyd-Warshall."""
    graph = _graph('bridged', 128, seed=3)
    closed = K.floyd_warshall_plain(_padded(graph), tile=tile).numpy()
    np.testing.assert_allclose(closed, _dijkstra(graph), rtol=1e-13, atol=0)


def test_zero_distance_duplicates_are_not_linked():
    """Two copies of one point are 0 apart and share no edge: their
    distance goes through a third point, as in the CSR copy scipy reads."""
    graph = np.array([[0, 0, 1], [0, 0, 1], [1, 1, 0]], np.float32)
    got = K.shortest_paths(graph, 'cpu')
    np.testing.assert_array_equal(got, _dijkstra(graph).astype(np.float32))
    assert got[0, 1] == 2.0


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        K.floyd_warshall(torch.zeros((B, B), dtype=torch.float64,
                                     device='meta'))


@pytest.mark.parametrize('n', [40, 90])
def test_geodesic_on_cpu_keeps_host_dijkstra(n):
    """On the CPU geodesic_distances runs scipy's Dijkstra and records it
    on its span; K4 counts no closure."""
    x = np.random.RandomState(n).randn(n, 6).astype(np.float32)
    K.floyd_warshall.launches = 0
    with timing.span('root') as root:
        got = td.geodesic_distances(x, kmax=10, device='cpu')
    (sp,) = root.find('distances.shortest_path')
    assert sp.counters == {'n': n, 'route': 'host_dijkstra'}
    assert K.floyd_warshall.launches == 0
    d = td.pairwise_distance(x, 'euclidean', device='cpu').numpy()
    graph = td._geodesic_graph(d, 5, 10, 5)[0]
    np.testing.assert_allclose(got, K.shortest_paths(graph, 'cpu'),
                               rtol=2 ** -23, atol=0)
