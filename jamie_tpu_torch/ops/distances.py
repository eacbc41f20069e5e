"""Sample-sample distance matrices.

Reference parity: `jamie_tpu/ops/distances.py` (`_pairwise_euclidean_impl`
:190-253, the other metrics :256-369, `pairwise_distance` :372-413,
`geodesic_distances` :429-460, `dataset_distance_matrix` :463-497). The
euclidean family goes through the K3 kernel (`ops/pairwise.py`) on the
card; geodesic computes its euclidean base matrix there, fetches it, and
grows the kNN graph, bridges components and runs Dijkstra on the host with
scipy, as `jamie_tpu` does.

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
shipped as CSR, decoded to exact f32 on the device and goes through K3 as
a dense one does: it is never densified on the host, whatever the
threshold.

The other metrics run where jamie_tpu runs them. cosine, correlation,
spearman, pearson, kulsinski, sokalmichener and wminkowski are Gram
products or row-blocked broadcasts in torch on the device. The rest are
host fallbacks: jamie_tpu calls sklearn's `pairwise_distances`, which the
card's machine does not have, so here they are scipy's
`squareform(pdist(X))` with sklearn's conventions (X taken as bool for
sklearn's boolean metrics, `l1`/`manhattan` as `cityblock`), and
`nan_euclidean` and `haversine` are sklearn's formulas in torch.

On a device mesh (`mesh=`, a `core.mesh` DeviceMesh with a 'data' axis)
euclidean, sqeuclidean, cosine and correlation are row-sharded as in
jamie_tpu (:163-186, 231-238, 391-394): each rank pads the rows to the
axis size and computes its row block against the whole matrix (through K3
for the euclidean family), the true diagonal (i, r b + i) of rank r's
block is zeroed explicitly, and the blocks are all-gathered, because the
host graph and the solver's setup need the whole matrix. As in jamie_tpu,
the routes past `_FEATURE_CHUNK_THRESHOLD` and the other metrics ignore
the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import mesh as cm
from ..core import residency, timing
from ..core.dtypes import bf16_matmul, resolve_device
from ..core.hostmat import as_f32_ndarray, densify, ensure_col_major, \
    is_scipy_sparse
from .pairwise import pairwise_euclidean

# scipy's pdist on the host (jamie_tpu's sklearn fallbacks, :29-34, less
# the two sklearn-only metrics written below in torch)
_HOST_FALLBACK_METRICS = (
    'l1', 'manhattan', 'cityblock', 'braycurtis', 'canberra', 'chebyshev',
    'dice', 'hamming', 'jaccard', 'mahalanobis', 'matching',
    'minkowski', 'rogerstanimoto', 'russellrao', 'seuclidean',
    'sokalsneath', 'yule',
)
# sklearn's PAIRWISE_BOOLEAN_FUNCTIONS: it converts X to bool for these
_BOOLEAN_METRICS = ('dice', 'jaccard', 'rogerstanimoto', 'russellrao',
                    'sokalsneath', 'yule')
# sklearn's own names for scipy's metrics
_SCIPY_NAMES = {'l1': 'cityblock', 'manhattan': 'cityblock'}

# Past this many elements a host matrix goes through the shared bf16
# residency, or past its budget through feature chunks
# (jamie_tpu/ops/distances.py:130). The one bf16 pivot, kept for the reason
# core/residency.BF16_LINK_ELEMS states. Read at call time.
_FEATURE_CHUNK_THRESHOLD = 100_000_000

# Rows per block when reducing squared norms of a bf16 matrix, so no f32
# copy of the whole matrix exists
_NORM_BLOCK_BYTES = 1 << 30


def _as_device_f32(x, device) -> torch.Tensor:
    """x (host array, scipy-sparse matrix or tensor) as a contiguous
    float32 tensor on device. A scipy-sparse matrix travels as CSR and is
    decoded on the device, exactly: it is never densified on the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    if is_scipy_sparse(x):
        return residency.csr_to_device(x, device)
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


def _sharded_rows(mesh, x: torch.Tensor, block_fn,
                  self_dist: bool) -> torch.Tensor:
    """block_fn(this rank's padded row block of x) -> its block of the
    output rows; the blocks all-gathered and the pad rows sliced
    off. self_dist zeroes the true diagonal (i, start + i) of the block."""
    n = x.shape[0]
    start, b = cm.row_block(n, mesh)
    d = block_fn(cm.shard_rows(mesh, x))
    if self_dist:
        i = torch.arange(min(b, max(n - start, 0)), device=d.device)
        d[i, start + i] = 0.0
    return cm.gather_plain(d, cm.block_split(b, mesh))[:n]


def _pairwise_euclidean_impl(x, y=None, squared: bool = False,
                             device=None, mesh=None) -> torch.Tensor:
    """Euclidean distances of host arrays (dense or scipy-sparse) or
    tensors, by jamie_tpu's routing (distances.py:190-253); under the
    threshold, row-sharded over `mesh`'s 'data' axis when one is given."""
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
                timing.note(route='distance_resident_bf16')
                return _euclidean_resident_bf16(xdev, squared, True)
        xs = x if isinstance(x, torch.Tensor) else ensure_col_major(x)
        ys = (xs if y is None else y if isinstance(y, torch.Tensor)
              else ensure_col_major(y))
        residency.route_counts['distance_feature_chunked'] += 1
        timing.note(route='distance_feature_chunked')
        return _pairwise_euclidean_feature_chunked(xs, ys, squared,
                                                   self_dist, device)
    xt = _as_device_f32(x, device)
    yt = None if self_dist else _as_device_f32(y, device)
    timing.note(route='k3' if mesh is None else 'k3_mesh')
    if mesh is not None:
        other = xt if self_dist else yt
        return _sharded_rows(
            mesh, xt, lambda xb: pairwise_euclidean(xb, other,
                                                    squared=squared),
            self_dist)
    return pairwise_euclidean(xt, yt, squared=squared)


def pairwise_sq_euclidean(x, y=None, block: int = 4096,
                          device=None) -> torch.Tensor:
    """Squared euclidean distances of x (to y, else to itself) on `device`:
    the squared route of the dispatch above (K3 under the thresholds).
    `block` is accepted for jamie_tpu's signature and ignored: K3 tiles
    the rows itself, and the routes past the thresholds choose their own
    blocks."""
    return _pairwise_euclidean_impl(x, y, squared=True, device=device)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


def _cosine_dist(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """1 - cos, clipped to [0, 2] (distances.py:256-261); row-sharded on
    a mesh (:202-213)."""
    xn = _unit_rows(x)
    if mesh is not None:
        return _sharded_rows(
            mesh, xn, lambda xb: torch.clamp(1.0 - xb @ xn.T, 0.0, 2.0),
            False)
    return torch.clamp(1.0 - xn @ xn.T, 0.0, 2.0)


def _correlation_dist(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """1 - Pearson r of the rows, clipped to [0, 2] (:264-271)."""
    return _cosine_dist(x - x.mean(1, keepdim=True), mesh)


def _corrcoef_similarity(x: torch.Tensor) -> torch.Tensor:
    """Row-row Pearson correlation matrix, np.corrcoef semantics
    (:288-294)."""
    xn = _unit_rows(x - x.mean(1, keepdim=True))
    return xn @ xn.T


def _rank_rows(x: torch.Tensor) -> torch.Tensor:
    """Average ranks per row (scipy.stats.rankdata method='average'),
    exact on ties: a tie group's rank is (first + last + 2) / 2 of its
    span in the sorted row (:297-312). The spans come from running
    max/min of the group edges rather than searchsorted, whose binary
    search torch does not define on NaN; NaNs sort last and tie with each
    other, as in jamie_tpu's searchsorted."""
    s, order = torch.sort(x, dim=1)
    n = s.shape[1]
    same = (s[:, 1:] == s[:, :-1]) | (torch.isnan(s[:, 1:])
                                      & torch.isnan(s[:, :-1]))
    edge = torch.zeros_like(same[:, :1])
    pos = torch.arange(n, device=x.device).expand_as(s)
    first = torch.where(torch.cat([edge, same], 1), 0, pos).cummax(1).values
    last = torch.where(torch.cat([same, edge], 1), n, pos).flip(1).cummin(
        1).values.flip(1)
    avg = (first + last + 2).to(torch.float32) / 2.0
    return torch.empty_like(avg).scatter_(1, order, avg)


def _bool_counts(x: torch.Tensor):
    """(n features, c_TF + c_FT, c_TT) of the rows taken as (x != 0), from
    one Gram of the 0/1 matrix (counts are exact in f32)."""
    b = (x != 0).to(torch.float32)
    s = b.sum(1)
    ctt = b @ b.T
    return float(x.shape[1]), s[:, None] + s[None, :] - 2.0 * ctt, ctt


def _kulsinski_dist(x: torch.Tensor) -> torch.Tensor:
    """scipy<=1.10 kulsinski: (c_TF + c_FT - c_TT + n) / (c_FT + c_TF + n)
    (:327-336)."""
    n, r, ctt = _bool_counts(x)
    return (r - ctt + n) / (r + n)


def _sokalmichener_dist(x: torch.Tensor) -> torch.Tensor:
    """scipy<=1.16 sokalmichener: 2R / (S + 2R), R = c_TF + c_FT, S = c_FF
    + c_TT (:339-349)."""
    n, r, _ = _bool_counts(x)
    return torch.where(r > 0, 2.0 * r / ((n - r) + 2.0 * r), 0.0)


def _wminkowski_dist(x: torch.Tensor, p: float = 2.0, w=None,
                     block: int = 256) -> torch.Tensor:
    """scipy<1.8 wminkowski, (sum_i |w_i (u_i - v_i)|^p)^(1/p), w ones by
    default (:352-369). Row blocks of `block` bound the (B, N, F)
    broadcast, which is reduced in place."""
    w = (torch.ones(x.shape[1], dtype=torch.float32, device=x.device)
         if w is None else torch.as_tensor(w, dtype=torch.float32,
                                           device=x.device))
    parts = []
    for s in range(0, x.shape[0], block):
        d = x[s:s + block, None, :] - x[None, :, :]
        parts.append(d.mul_(w).abs_().pow_(p).sum(-1).pow_(1.0 / p))
    return torch.cat(parts)


def _nan_euclidean_dist(x: torch.Tensor) -> torch.Tensor:
    """sklearn's nan_euclidean_distances(X): the squared distance over the
    coordinates present in both rows, scaled by n_features / n_present,
    NaN where no coordinate is shared; in float64, as sklearn upcasts."""
    x = x.double()
    missing = torch.isnan(x)
    x0 = torch.where(missing, 0.0, x)
    present = (~missing).double()
    x0sq = x0 * x0
    sq = x0sq.sum(1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x0 @ x0.T)
    d -= x0sq @ missing.double().T
    d -= missing.double() @ x0sq.T
    d.clamp_(min=0.0).fill_diagonal_(0.0)
    count = present @ present.T
    d[count == 0] = float('nan')
    d *= x.shape[1] / torch.clamp(count, min=1.0)
    return d.sqrt_().float()


def _haversine_dist(x: torch.Tensor) -> torch.Tensor:
    """sklearn's haversine_distances(X) on (latitude, longitude) rows in
    radians, in float64."""
    if x.shape[1] != 2:
        raise ValueError('Haversine distance only valid in 2 dimensions')
    lat, lon = x.double().unbind(1)
    h = (torch.sin((lat[:, None] - lat[None, :]) / 2) ** 2
         + torch.cos(lat)[:, None] * torch.cos(lat)[None, :]
         * torch.sin((lon[:, None] - lon[None, :]) / 2) ** 2)
    return (2.0 * torch.arcsin(torch.sqrt(h))).float()


# The metrics computed in torch on the device
_TORCH_METRICS = {'cosine': _cosine_dist, 'correlation': _correlation_dist,
                  'kulsinski': _kulsinski_dist,
                  'sokalmichener': _sokalmichener_dist,
                  'wminkowski': _wminkowski_dist,
                  'nan_euclidean': _nan_euclidean_dist,
                  'haversine': _haversine_dist}


def _host_metric(x: np.ndarray, metric: str) -> np.ndarray:
    """sklearn's pairwise_distances(X, metric) for a scipy metric, as
    sklearn computes it for Y=None: squareform(pdist(X)) (pdist estimates
    seuclidean's V and mahalanobis's VI from X alone, as sklearn does),
    with X as bool for sklearn's boolean metrics."""
    from scipy.spatial.distance import pdist, squareform
    if metric in _BOOLEAN_METRICS:
        x = x.astype(bool)
    return squareform(pdist(x, _SCIPY_NAMES.get(metric, metric)))


def pairwise_distance(x, metric: str = 'euclidean', block: int = 4096,
                      mesh=None, device=None) -> torch.Tensor:
    """N x N distance matrix of one dataset, on `device` (the card unless
    the caller asks for another); the dispatch of distances.py:372-413.
    mesh: row-shard the euclidean family, cosine and correlation over its
    'data' axis; every rank returns the whole matrix. `block` is accepted
    for jamie_tpu's signature and ignored, as in pairwise_sq_euclidean."""
    cm.check_mesh(mesh)
    if metric in ('euclidean', 'l2', 'sqeuclidean'):
        return _pairwise_euclidean_impl(
            x, squared=(metric == 'sqeuclidean'), device=device, mesh=mesh)
    device = resolve_device(device)
    if is_scipy_sparse(x):
        x = densify(x)     # only the euclidean family streams sparse blocks
    if metric in ('cosine', 'correlation'):
        return _TORCH_METRICS[metric](_as_device_f32(x, device), mesh)
    if metric in _TORCH_METRICS:
        return _TORCH_METRICS[metric](_as_device_f32(x, device))
    if metric in _HOST_FALLBACK_METRICS:
        host = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x, np.float32))
        try:
            d = _host_metric(host, metric)
        except (ValueError, TypeError) as e:
            raise ValueError(
                f'metric {metric!r} is advertised for parity with the '
                f'reference (jamie/jamie.py:117-127) but the installed scipy '
                f'no longer implements it: {e}') from e
        return torch.as_tensor(d, dtype=torch.float32, device=device)
    raise ValueError(f'Unknown metric {metric!r}')


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
                       device=None, mesh=None) -> np.ndarray:
    """Geodesic (kNN-graph shortest-path) distances: grow k from kmin by
    kstep until the kNN graph is connected (capped at kmax), bridge any
    components left, then all-pairs Dijkstra. The euclidean base matrix is
    computed on `device` (row-sharded over `mesh`); the graph work runs on
    the host, on every rank. Each of the three is a span: `distances.base`
    (with its copy to the host), `distances.knn_graph` (the k reached, the
    rounds, whether components were bridged) and `distances.shortest_path`."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components, shortest_path

    with timing.span('distances.base'):
        dist = pairwise_distance(data, 'euclidean', device=device,
                                 mesh=mesh).cpu().numpy()
    n = dist.shape[0]
    if n == 1:
        return np.zeros((1, 1), np.float32)
    with timing.span('distances.knn_graph') as knn:
        graph = None
        for rounds, k in enumerate(range(kmin, max(kmax, kmin) + 1, kstep),
                                   1):
            graph = _knn_graph(dist, min(k, n - 1))
            n_comp, _ = connected_components(csr_matrix(graph),
                                             directed=False)
            if n_comp == 1:
                break
        else:
            # Still disconnected at kmax: bridge components at their
            # closest pair
            from ..nn_funcs import connect_graph
            graph = connect_graph(graph, dist)
        knn.set(k=min(k, n - 1), rounds=rounds, bridged=n_comp > 1)
    with timing.span('distances.shortest_path'):
        sp = shortest_path(csr_matrix(graph), method='D', directed=False)
        # Unreachable pairs (shouldn't happen post-connect) -> max finite
        # distance
        finite_max = np.nanmax(np.where(np.isinf(sp), np.nan, sp))
        sp = np.where(np.isinf(sp), finite_max, sp)
        return sp.astype(np.float32)


def dataset_distance_matrix(data, distance_mode: str = 'euclidean',
                            kmax: int = 40, device=None, mesh=None):
    """Distance matrix dispatch (jamie/jamie.py:851-885): a host ndarray
    for geodesic (as jamie_tpu), a device tensor for every other mode.
    scipy-sparse data passes through to the sparse-aware euclidean routes;
    spearman and pearson densify it. `mesh` reaches the modes jamie_tpu
    shards (geodesic's base matrix and pairwise_distance's)."""
    if is_scipy_sparse(data):
        if distance_mode in ('spearman', 'pearson'):
            data = densify(data)
    elif not isinstance(data, torch.Tensor):
        data = as_f32_ndarray(data)   # keeps the identity the caches key on
    if distance_mode == 'geodesic':
        return geodesic_distances(data, kmax=kmax, device=device, mesh=mesh)
    with timing.span('distances.base', route=distance_mode):
        if distance_mode in ('spearman', 'pearson'):
            if data.shape[0] == 1:
                return np.zeros((1, 1), np.float32)
            x = _as_device_f32(data, resolve_device(device))
            if distance_mode == 'pearson':
                return (1.0 - _corrcoef_similarity(x)) / 2.0
            sim = _corrcoef_similarity(_rank_rows(x))
            # as jamie_tpu checks (:484-488); ranks are finite, so this
            # guards the similarity's own arithmetic
            if bool(torch.isnan(sim).any()):
                raise ValueError(
                    'Data is not well conditioned for spearman method '
                    '(rank correlation returned nan)')
            return (1.0 - sim) / 2.0
        return pairwise_distance(data, metric=distance_mode, device=device,
                                 mesh=mesh)
