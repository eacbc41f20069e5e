"""Sample-sample distance matrices.

Reference parity: `jamie_tpu/ops/distances.py` (`_pairwise_euclidean_impl`
:190-253, `dataset_distance_matrix` :463-497, `geodesic_distances`
:429-460). The euclidean family goes through the K3 kernel
(`ops/pairwise.py`) on the card; geodesic computes its euclidean base
matrix there, fetches it, and grows the kNN graph, bridges components and
runs Dijkstra on the host with scipy, as `jamie_tpu` does.

Host sources past `_FEATURE_CHUNK_THRESHOLD` elements (compared with `>`,
as jamie_tpu does) take jamie_tpu's large-matrix routes, which round the
values to bf16 and accumulate in f32:

- a self-distance reads the shared bf16 residency (`core/residency.
  device_bf16`) and runs one Gram from it (`_euclidean_resident_bf16`);
- when the residency does not fit, or for a cross distance, the Gram is
  accumulated over feature chunks streamed from the host
  (`_pairwise_euclidean_feature_chunked`).

Those Gram products are plain large matmuls that jamie_tpu leaves to XLA,
so here they are `torch.mm` with bf16 operands and an f32 result
(`core/dtypes.bf16_matmul`). A scipy-sparse source under the threshold is
densified and goes through K3 as a dense one does.

Not ported (NotImplementedError): the other metrics (ROADMAP.md item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import residency
from ..core.dtypes import bf16_matmul, resolve_device
from ..core.hostmat import as_f32_ndarray, densify, ensure_col_major, \
    is_scipy_sparse
from .pairwise import pairwise_euclidean

PORTED_MODES = ('euclidean', 'l2', 'sqeuclidean', 'geodesic')

# Past this many elements a host matrix goes through the shared bf16
# residency, or past its budget through feature chunks
# (jamie_tpu/ops/distances.py:130). Read at call time.
_FEATURE_CHUNK_THRESHOLD = 100_000_000

# Rows per block when reducing squared norms of a bf16 matrix, so no f32
# copy of the whole matrix exists
_NORM_BLOCK_BYTES = 1 << 30


def _as_device_f32(x, device) -> torch.Tensor:
    """x (host array or tensor) as a contiguous float32 tensor on device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(as_f32_ndarray(x), device=device).contiguous()


def _row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Per-row sum of squares of a (bf16) matrix in f32, in row blocks."""
    rows = max(_NORM_BLOCK_BYTES // max(4 * x.shape[1], 1), 1)
    return torch.cat([x[s:s + rows].float().square().sum(1)
                      for s in range(0, x.shape[0], rows)])


def _finish(d2: torch.Tensor, squared: bool, self_dist: bool) -> torch.Tensor:
    """Clamp, optional sqrt and zero diagonal, in place."""
    d2.clamp_(min=0.0)
    if not squared:
        d2.sqrt_()
    if self_dist:
        d2.fill_diagonal_(0.0)
    return d2


def _euclidean_resident_bf16(x_bf16: torch.Tensor, squared: bool,
                             self_dist: bool) -> torch.Tensor:
    """Self distances straight from a device-resident bf16 matrix: one
    bf16 Gram with an f32 result and f32-accumulated norms of the bf16
    values; no f32 copy of the matrix exists."""
    sq = _row_sq_norms(x_bf16)
    d2 = bf16_matmul(x_bf16, x_bf16.T).mul_(-2.0)
    d2.add_(sq[:, None]).add_(sq[None, :])
    return _finish(d2, squared, self_dist)


def _pairwise_euclidean_feature_chunked(x, y, squared: bool, self_dist: bool,
                                        device, chunk_bytes: int = 2 << 30):
    """Accumulate the Gram over feature chunks: each chunk's product with
    bf16 operands and an f32 result, and the squared norms of the f32
    blocks, on the device. Host sources stream through
    `residency.ChunkUploader` (sparse ones should arrive CSC); a device
    tensor is sliced where it lies."""
    def col_source(a):
        if isinstance(a, torch.Tensor):
            return lambda s, e: a[:, s:e].to(device=device,
                                             dtype=torch.float32)
        return residency.ChunkUploader(a, device).cols

    n, f = (int(d) for d in x.shape)
    m = int(y.shape[0])
    chunk = max(int(chunk_bytes / ((n + m) * 4)), 1024)
    acc = torch.zeros((n, m), dtype=torch.float32, device=device)
    x_sq = torch.zeros(n, dtype=torch.float32, device=device)
    y_sq = torch.zeros(m, dtype=torch.float32, device=device)
    same = self_dist and y is x
    xcols = col_source(x)
    ycols = xcols if same else col_source(y)
    for s in range(0, f, chunk):
        xb = xcols(s, s + chunk)
        yb = xb if same else ycols(s, s + chunk)
        acc.add_(bf16_matmul(xb, yb.T))
        x_sq.add_(xb.square().sum(1))
        y_sq.add_(yb.square().sum(1))
    d2 = acc.mul_(-2.0).add_(x_sq[:, None]).add_(y_sq[None, :])
    return _finish(d2, squared, self_dist)


def _pairwise_euclidean_impl(x, y=None, squared: bool = False,
                             device=None) -> torch.Tensor:
    """Euclidean distances of host arrays (dense or scipy-sparse) or
    tensors, by jamie_tpu's routing (distances.py:190-253)."""
    device = resolve_device(device)
    self_dist = y is None
    # tensors are already resident: never the host-streaming routes
    device_in = isinstance(x, torch.Tensor) and (
        y is None or isinstance(y, torch.Tensor))
    if (not device_in and len(x.shape) == 2
            and int(x.shape[0]) * int(x.shape[1]) > _FEATURE_CHUNK_THRESHOLD):
        if self_dist:
            xdev = residency.device_bf16(
                x if isinstance(x, np.ndarray) or is_scipy_sparse(x)
                else np.asarray(x), device=device)
            if xdev is not None:
                residency.route_counts['distance_resident_bf16'] += 1
                return _euclidean_resident_bf16(xdev, squared, True)
        xs = x if isinstance(x, torch.Tensor) else ensure_col_major(x)
        ys = (xs if y is None else y if isinstance(y, torch.Tensor)
              else ensure_col_major(y))
        residency.route_counts['distance_feature_chunked'] += 1
        return _pairwise_euclidean_feature_chunked(xs, ys, squared,
                                                   self_dist, device)
    if is_scipy_sparse(x):
        x = densify(x)
    if is_scipy_sparse(y):
        y = densify(y)
    xt = _as_device_f32(x, device)
    yt = None if self_dist else _as_device_f32(y, device)
    return pairwise_euclidean(xt, yt, squared=squared)


def pairwise_distance(x, metric: str = 'euclidean',
                      device=None) -> torch.Tensor:
    """N x N distance matrix of one dataset, on `device` (the card unless
    the caller asks for another)."""
    if metric not in ('euclidean', 'l2', 'sqeuclidean'):
        raise NotImplementedError(
            f'metric {metric!r} is ROADMAP.md item 12; ported metrics: '
            'euclidean, l2, sqeuclidean')
    return _pairwise_euclidean_impl(x, squared=(metric == 'sqeuclidean'),
                                    device=device)


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
    for the euclidean family, a host ndarray for geodesic (as jamie_tpu).
    scipy-sparse data passes through to the sparse-aware routes."""
    if distance_mode not in PORTED_MODES:
        raise NotImplementedError(
            f'distance_mode {distance_mode!r} is ROADMAP.md item 12; ported '
            f'modes: {", ".join(PORTED_MODES)}')
    if not (is_scipy_sparse(data) or isinstance(data, torch.Tensor)):
        data = as_f32_ndarray(data)   # keeps the identity the caches key on
    if distance_mode == 'geodesic':
        return geodesic_distances(data, kmax=kmax, device=device)
    return pairwise_distance(data, metric=distance_mode, device=device)
