"""Sample-sample distance matrices.

Reference parity: `jamie_tpu/ops/distances.py` (`dataset_distance_matrix`
:463-497, `geodesic_distances` :429-460). The euclidean family goes through
the K3 kernel (`ops/pairwise.py`) on the card; geodesic computes its
euclidean base matrix there, fetches it, and grows the kNN graph, bridges
components and runs Dijkstra on the host with scipy, as `jamie_tpu` does.

Not ported yet (NotImplementedError): the other metrics (ROADMAP.md item
12), scipy-sparse inputs and matrices above `_FEATURE_CHUNK_THRESHOLD`
elements, where `jamie_tpu` switches to its bf16-resident and streamed
routes (item 11).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import resolve_device
from ..core.hostmat import as_f32_ndarray, is_scipy_sparse
from .pairwise import pairwise_euclidean

PORTED_MODES = ('euclidean', 'l2', 'sqeuclidean', 'geodesic')

# Past this many elements jamie_tpu rounds the matrix to a bf16 device
# residency or streams feature chunks (jamie_tpu/ops/distances.py:130);
# those routes change the numerics and are not ported.
_FEATURE_CHUNK_THRESHOLD = 100_000_000


def _check_source(x) -> None:
    """Refuse the host inputs whose jamie_tpu routes are not ported:
    scipy-sparse matrices and dense ones past `_FEATURE_CHUNK_THRESHOLD`
    elements (ROADMAP.md item 11). Tensors are already resident."""
    if isinstance(x, torch.Tensor):
        return
    if is_scipy_sparse(x):
        raise NotImplementedError(
            'sparse inputs are ROADMAP.md item 11 (sparse and atlas data '
            'inputs); pass a dense array')
    if np.ndim(x) == 2 and x.shape[0] * x.shape[1] > _FEATURE_CHUNK_THRESHOLD:
        raise NotImplementedError(
            f'a {x.shape[0]} x {x.shape[1]} matrix is past the '
            f'{_FEATURE_CHUNK_THRESHOLD:,}-element bf16-resident threshold: '
            'ROADMAP.md item 11 (sparse and atlas data inputs)')


def _as_device_f32(x, device) -> torch.Tensor:
    """x (host array or tensor) as a contiguous float32 tensor on device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(as_f32_ndarray(x), device=device).contiguous()


def pairwise_distance(x, metric: str = 'euclidean',
                      device=None) -> torch.Tensor:
    """N x N distance matrix of one dataset, on `device` (the card unless
    the caller asks for another)."""
    if metric not in ('euclidean', 'l2', 'sqeuclidean'):
        raise NotImplementedError(
            f'metric {metric!r} is ROADMAP.md item 12; ported metrics: '
            'euclidean, l2, sqeuclidean')
    _check_source(x)
    xt = _as_device_f32(x, resolve_device(device))
    return pairwise_euclidean(xt, squared=(metric == 'sqeuclidean'))


def _knn_graph(dist: np.ndarray, k: int) -> np.ndarray:
    """Symmetric kNN distance graph from a dense distance matrix."""
    n = dist.shape[0]
    idx = np.argpartition(dist, min(k + 1, n - 1), axis=1)[:, :k + 1]
    graph = np.zeros_like(dist)
    rows = np.repeat(np.arange(n), idx.shape[1])
    cols = idx.ravel()
    graph[rows, cols] = dist[rows, cols]
    np.fill_diagonal(graph, 0)
    graph = np.maximum(graph, graph.T)
    return graph


def geodesic_distances(data, kmax: int = 40, kmin: int = 5, kstep: int = 5,
                       device=None) -> np.ndarray:
    """Geodesic (kNN-graph shortest-path) distances: grow k from kmin by
    kstep until the kNN graph is connected (capped at kmax), bridge any
    components left, then all-pairs Dijkstra. The euclidean base matrix is
    computed on `device`; the graph work runs on the host."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components, shortest_path

    dist = pairwise_distance(data, 'euclidean', device=device).cpu().numpy()
    n = dist.shape[0]
    if n == 1:
        return np.zeros((1, 1), np.float32)
    graph = None
    for k in range(kmin, max(kmax, kmin) + 1, kstep):
        graph = _knn_graph(dist, min(k, n - 1))
        n_comp, _ = connected_components(csr_matrix(graph), directed=False)
        if n_comp == 1:
            break
    else:
        # Still disconnected at kmax: bridge components at their closest pair
        from ..nn_funcs import connect_graph
        graph = connect_graph(graph, dist)
    sp = shortest_path(csr_matrix(graph), method='D', directed=False)
    # Unreachable pairs (shouldn't happen post-connect) -> max finite distance
    finite_max = np.nanmax(np.where(np.isinf(sp), np.nan, sp))
    sp = np.where(np.isinf(sp), finite_max, sp)
    return sp.astype(np.float32)


def dataset_distance_matrix(data, distance_mode: str = 'euclidean',
                            kmax: int = 40, device=None):
    """Distance matrix dispatch (jamie/jamie.py:851-885): a device tensor
    for the euclidean family, a host ndarray for geodesic (as jamie_tpu)."""
    if distance_mode not in PORTED_MODES:
        raise NotImplementedError(
            f'distance_mode {distance_mode!r} is ROADMAP.md item 12; ported '
            f'modes: {", ".join(PORTED_MODES)}')
    if distance_mode == 'geodesic':
        return geodesic_distances(data, kmax=kmax, device=device)
    return pairwise_distance(data, metric=distance_mode, device=device)
