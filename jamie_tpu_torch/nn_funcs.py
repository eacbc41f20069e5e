"""Graph/kNN utilities and legacy manifold-alignment losses.

Reference parity: `jamie_tpu/nn_funcs.py` (jamie/nn_funcs.py) —
`connect_graph` component bridging, `knn_dist` the connected kNN affinity
with a Gaussian kernel, `knn_sim` the bipartite kNN on a correspondence
matrix, and the legacy losses `uc_loss`, `nlma_loss` and `gw_loss`, kept as
API (the training path does not call them).

Device/host split as in jamie_tpu: `knn_dist`'s squared distances come
from the K3 kernel (`ops/distances.py`) on `device`; the stable argsort,
the symmetric scatter and the component bridging stay on the host (numpy,
scipy). The losses are torch functions of tensors. `gw_loss` takes its
distances through `ops/pairwise.pairwise_euclidean_autograd`, so its
gradient flows through K3 and is 0 (not NaN) where a distance is 0: the
deliberate deviation from jamie_tpu, whose sqrt at the zero diagonal makes
every entry of its gradient NaN.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse.csgraph import connected_components

from .ops.distances import pairwise_distance
from .ops.pairwise import pairwise_euclidean_autograd


def connect_graph(adj: np.ndarray, weights: np.ndarray = None) -> np.ndarray:
    """Bridge disconnected components of `adj` into one.

    Components are chained in label order: each consecutive pair (c, c+1)
    gains one symmetric edge at the cheapest cross entry of `weights`
    (defaults to `adj` itself). Returns a copy.
    """
    adj = np.array(adj)
    weights = adj if weights is None else np.asarray(weights)
    n_comp, labels = connected_components(adj, directed=False)
    groups = [np.flatnonzero(labels == c) for c in range(n_comp)]
    for a, b in zip(groups[:-1], groups[1:]):
        block = weights[np.ix_(a, b)]
        flat = int(np.argmin(block))
        i, j = a[flat // len(b)], b[flat % len(b)]
        adj[i, j] = adj[j, i] = block.flat[flat]
    return adj


def _symmetric_knn_adjacency(scores: np.ndarray,
                             neighbors: np.ndarray) -> np.ndarray:
    """Scatter per-row neighbor scores into a symmetrized dense adjacency.

    `neighbors` is (n, k) column indices per row; both (i -> j) and
    (j -> i) slots are written so the graph is undirected.
    """
    n, k = neighbors.shape
    rows = np.repeat(np.arange(n), k)
    cols = neighbors.ravel()
    adj = np.zeros_like(scores)
    adj[rows, cols] = scores[rows, cols]
    adj[cols, rows] = scores[cols, rows]
    return adj


def knn_dist(data, k: int = 5, device=None) -> np.ndarray:
    """Connected kNN affinity with a Gaussian kernel: each sample links to
    its k nearest others (self-distance 0 sorts first and is skipped),
    components are bridged, and surviving edges map through exp(-d). The
    squared distances are K3's on `device` (the card unless the caller asks
    for another)."""
    d2 = pairwise_distance(np.asarray(data, np.float32), 'sqeuclidean',
                           device=device).cpu().numpy()
    nearest = np.argsort(d2, axis=1, kind='stable')[:, 1:k + 1]
    graph = _symmetric_knn_adjacency(d2, nearest)
    graph = connect_graph(graph, d2)
    edges = graph > 0
    graph[edges] = np.exp(-graph[edges])
    return graph


def knn_sim(corr: np.ndarray, k: int = 5) -> np.ndarray:
    """Bipartite kNN over a correspondence matrix: the (n0, n1) similarity
    matrix becomes a (n0+n1)^2 bipartite graph in negated-similarity
    ("cost") form; each node keeps its k most-similar cross-side partners,
    components are bridged, and the top-right block returns to similarity
    sign. Host numpy, as in jamie_tpu."""
    corr = np.asarray(corr)
    n0, n1 = corr.shape
    cost = np.zeros((n0 + n1, n0 + n1), corr.dtype)
    cost[:n0, n0:] = -corr
    cost[n0:, :n0] = -corr.T
    strongest = np.argsort(cost, axis=1, kind='stable')[:, :k]
    graph = _symmetric_knn_adjacency(cost, strongest)
    graph = connect_graph(graph, cost)
    return -graph[:n0, n0:]


def uc_loss(primes, F):
    """UnionCom alignment term ||P0 - F P1||^2."""
    return torch.sum(torch.square(primes[0] - F @ primes[1]))


def nlma_loss(primes, Wx, Wy, Wxy, mu):
    """NLMA loss via the Laplacian trace: tr(P^T (D - W) P) with
    W = [[Wx, Wxy], [Wxy^T, Wy]] and D the column sums of Wx and Wy. `mu`
    is accepted for signature parity; the reference's fast path ignores
    it."""
    del mu
    D = torch.diag(torch.cat((Wx.sum(0), Wy.sum(0))))
    W = torch.cat((torch.cat((Wx, Wxy), 1), torch.cat((Wxy.T, Wy), 1)), 0)
    P = torch.cat(tuple(primes), 0)
    return torch.trace(P.T @ (D - W) @ P)


def gw_loss(primes):
    """Naive Gromov-Wasserstein distance, vectorized: the sum over pairs of
    (||x_i - x_j|| - ||y_i - y_j||)^2, its distances from K3."""
    assert all(len(primes[0]) == len(p) for p in primes), (
        'Datasets must be aligned')
    d0 = pairwise_euclidean_autograd(primes[0], squared=False)
    d1 = pairwise_euclidean_autograd(primes[1], squared=False)
    return torch.sum(torch.square(d0 - d1))
