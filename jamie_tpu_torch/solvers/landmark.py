"""Landmark (Nystrom-style) correspondence: prime-dual F past the dense N².

Reference parity: `jamie_tpu/solvers/landmark.py`. The dense solver holds
five (N0, N1) arrays; this one bounds the estimation at O(N L + L²):

1. pick L landmark cells per modality (farthest-point cover by default,
   or uniform), with the same `RandomState(seed)` draws as jamie_tpu, so
   both packages start from the same cell and draw the same subsets;
2. run the exact prime-dual solver (K1) on the (L, L) landmark distance
   matrices (K3, plus the host graph for geodesic);
3. extend to all cells with row-stochastic kNN-Gaussian weights A: each
   cell mixes its k nearest landmarks, bandwidth its own mean kNN squared
   distance, from squared distances in 8192-row blocks (K3, or an SpMM
   Gram for a CSR source);
4. return F = (A_x F_L) A_y^T as a `LowRankF`, or in the k-sparse
   `SparseLandmarkF` layout past `_SPARSE_FACTOR_ENTRIES`, with what the
   steps solved kept on it (`F.landmarks`, a `LandmarkSolve`).

Everything runs on `device` (the card unless the caller passes another).
FPS keeps its picks on the device: no host read inside its loop. With
`verbose` (the solver's flag, on by default) it prints the seconds of its
four steps, each ended by a device synchronize. Each step is a span
(`core/timing`) whose counters name its route and sizes: the selection's
`L`, `rows` and `route` ('fps_dense', 'fps_jl_sketch' or 'uniform'), the
distances' `mode` and `L`, the solve's `shape`, `state_dtype` and
`iterations`, the weights' `layout`, `route` ('weights_spmm',
'weights_uploader' or 'weights_dense'), `nnz` (a CSR source's, else None)
and `blocks`.

Sources may be dense host arrays, scipy CSR matrices or tensors, routed as
jamie_tpu routes them (the spans' `route` counters record which):

- FPS runs on a 256-dimensional JL sketch past `_FPS_BYTES_BUDGET` bytes of
  f32 (`_project_for_fps`: an SpMM on the source's DeviceCSR, or row
  blocks through `residency.ChunkUploader`), its projection drawn from the
  same `RandomState` as jamie_tpu's so the later draws stay in step;
- the cell-to-landmark weights of a CSR source come from the SpMM Gram
  with the DeviceCSR's row norms (values bf16-rounded at scale); a dense
  host source of `_UPLOAD_ELEMS` elements or more streams through the
  uploader; anything else goes through K3 directly;
- landmark rows of a CSR source are gathered with `X[lx].toarray()`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import graphs
from ..core import mesh as cm
from ..core import residency
from ..core.dtypes import resolve_device
from ..core.hostmat import dense_rows, is_scipy_sparse
from ..core import timing
from ..ops.distances import _as_device_f32, dataset_distance_matrix
from ..ops.lowrank import LowRankF, SparseLandmarkF
from ..ops.pairwise import pairwise_euclidean
from .prime_dual import prime_dual

# FPS keeps the whole matrix on the device in f32; past this many bytes it
# runs on a JL sketch (compared with `>`). jamie_tpu's value, kept: the
# `residency` probe found the sketch 1.2-4x faster than exact FPS at every
# size it ran (0.29-19 GB of f32; H100 80GB HBM3, 700.00 W), so a larger
# budget buys no time; below it the picks stay exact.
_FPS_BYTES_BUDGET = 2 << 30

# A dense host source of this many elements or more (`>=`) streams its
# cell-to-landmark weight blocks through the uploader (jamie_tpu writes
# the number at landmark.py:145), whose blocks carry the bf16 rounding of
# core/residency.BF16_LINK_ELEMS: the same pivot, kept for its reason.
_UPLOAD_ELEMS = 100_000_000

# Past this many dense-factor entries per side (N x L) the correspondence
# takes the k-sparse factor layout. jamie_tpu's value, kept: both layouts
# give the same F, the dense factors at it take 4.8 GB (6% of the card) and
# no probed fit reached it (195,313 cells at L = 2048).
_SPARSE_FACTOR_ENTRIES = 400_000_000


@dataclasses.dataclass
class LandmarkSolve:
    """What the landmark route solved on the way to F, kept on the F it
    returns (`F.landmarks`) so the stages can be checked: each modality's
    picks sorted (the order of the landmark rows, of the distance
    matrices' axes and of F_L's) and in the order they were picked, the
    (L0, L0) and (L1, L1) landmark distance matrices, and F_L."""
    picks: tuple
    order: tuple
    dist: tuple
    f_l: torch.Tensor


def _interp_weights_sparse(d2: torch.Tensor, k: int):
    """Row-stochastic kNN-Gaussian weights from squared cell->landmark
    distances, k-sparse: each row's k nearest landmark indices (int64) and
    their weights exp(-d2 / mean_knn_d2), normalized to sum 1."""
    neg, idx = torch.topk(-d2, k, dim=1)
    knn_d2 = -neg                                    # (n, k), ascending
    bw = torch.clamp(knn_d2.mean(1, keepdim=True), min=1e-12)
    w = torch.exp(-knn_d2 / bw)
    return idx, w / w.sum(1, keepdim=True)


def _interp_weights(d2: torch.Tensor, k: int, n_landmarks: int):
    """Dense (n, L) layout of `_interp_weights_sparse`."""
    idx, w = _interp_weights_sparse(d2, k)
    a = torch.zeros((d2.shape[0], n_landmarks), dtype=torch.float32,
                    device=d2.device)
    return a.scatter_(1, idx, w)


def _fps_indices_device(x: torch.Tensor, first: int,
                        n_landmarks: int) -> torch.Tensor:
    """Farthest-point sampling (greedy 2-approx k-center cover): repeatedly
    add the cell farthest from the chosen set, by the Gram formula
    sq + sq[nxt] - 2 x.x[nxt] and argmax's first index on ties. As
    jamie_tpu's `fori_loop` (:61-82), one pick is one step on static
    buffers with no host read: the argmax, its index written into the
    (L,) index buffer at the device counter, one mat-vec over x for the
    min-distance update. On the card the pick is captured once as a CUDA
    graph and replayed for the L - 2 picks after the first (the warm-up);
    elsewhere (`core/graphs.captures`) it runs op by op."""
    sq = (x * x).sum(1)

    def dist_to(j: torch.Tensor) -> torch.Tensor:
        xj = x.index_select(0, j)                    # (1, f)
        return torch.clamp(sq + sq.index_select(0, j) - 2.0 * (x @ xj.T)[:, 0],
                           min=0.0)

    idx = torch.full((int(n_landmarks),), int(first), dtype=torch.long,
                     device=x.device)
    d = dist_to(idx[:1])
    at = torch.ones((1,), dtype=torch.long, device=x.device)

    def pick():
        nxt = torch.argmax(d).reshape(1)
        idx.index_copy_(0, at, nxt)
        torch.minimum(d, dist_to(nxt), out=d)
        at.add_(1)
    graphs.steps_runner('fps', pick, x.device).run(int(n_landmarks) - 1)
    return idx


def _project_for_fps(arr, rng, dim: int = 256, chunk_rows: int = 8192,
                     device=None) -> torch.Tensor:
    """A (n, dim) random Gaussian projection of arr for FPS on modalities
    too large to sit on the device in f32: pairwise distances survive a JL
    sketch, which is all FPS consumes. The projection is drawn from `rng`
    as jamie_tpu draws it. A CSR source that fits the budget multiplies on
    its DeviceCSR (SpMM); other host sources stream row blocks through the
    uploader; a tensor is multiplied where it lies."""
    device = resolve_device(device)
    n, d = (int(s) for s in arr.shape)
    proj = torch.as_tensor(
        np.asarray(rng.randn(d, dim).astype(np.float32) / np.sqrt(dim),
                   np.float32), device=device)
    up = (None if isinstance(arr, torch.Tensor)
          else residency.ChunkUploader(arr, device))
    if up is not None and up.dcsr is not None:
        return up.dcsr.matmul(proj)
    out = []
    for s in range(0, n, chunk_rows):
        xb = (arr[s:s + chunk_rows].to(device=device, dtype=torch.float32)
              if up is None else up.rows(s, s + chunk_rows))
        out.append(xb @ proj)
    return torch.cat(out)


def _pick_landmarks(x, n_landmarks: int, method: str, rng, device=None):
    """(the picks in the order they were made, the route taken): 'uniform'
    draws them at once; 'fps' picks on the exact rows ('fps_dense') or,
    past `_FPS_BYTES_BUDGET`, on the JL sketch ('fps_jl_sketch')."""
    n = int(x.shape[0])
    if method == 'uniform':
        return rng.choice(n, n_landmarks, replace=False), 'uniform'
    if method == 'fps':
        device = resolve_device(device)
        first = int(rng.randint(n))
        if int(x.shape[0]) * int(x.shape[1]) * 4 > _FPS_BYTES_BUDGET:
            route = 'fps_jl_sketch'
            xd = _project_for_fps(x, rng, device=device)
        else:
            route = 'fps_dense'
            xd = _as_device_f32(x, device)
        return (_fps_indices_device(xd, first, int(n_landmarks)).cpu()
                .numpy(), route)
    raise ValueError(f'unknown landmark selection method {method!r}')


def _cell_to_landmark_weights(x, landmarks, k: int, block: int = 8192,
                              sparse: bool = False, device=None):
    """A (n, L) in row blocks, so the (n, L) distance intermediate stays
    bounded. A CSR source that fits the budget takes the SpMM Gram on its
    DeviceCSR, |x|^2 + |l|^2 - 2 x.l with the DeviceCSR's row norms;
    otherwise each block's squared distances come from K3 (cross,
    squared), the block read through the uploader for a host source of
    `_UPLOAD_ELEMS` elements or more, exactly otherwise. sparse=True
    returns the k-sparse layout (idx (n, k) int64, w (n, k) f32) instead
    of the dense matrix."""
    device = (x.device if isinstance(x, torch.Tensor) and device is None
              else resolve_device(device))
    lm = _as_device_f32(landmarks, device)
    n, L = int(x.shape[0]), int(lm.shape[0])
    host = not isinstance(x, torch.Tensor)
    dcsr = residency.device_csr(x, device=device) if host else None
    up = (residency.ChunkUploader(x, device)
          if host and dcsr is None and n * int(x.shape[1]) >= _UPLOAD_ELEMS
          else None)
    route = ('weights_spmm' if dcsr is not None else
             'weights_uploader' if up is not None else 'weights_dense')
    # the enclosing span's counters, one entry a modality
    sp = timing.current()
    if sp is not None:
        sp.counters.setdefault('route', []).append(route)
        sp.counters.setdefault('nnz', []).append(
            None if dcsr is None else dcsr.nnz)
        sp.add('blocks', -(-n // block))
    lm_sq = (lm * lm).sum(1) if dcsr is not None else None
    verbose = n >= 50_000        # atlas scale: show block progress
    t0 = time.perf_counter()
    parts = []
    for s in range(0, n, block):
        e = min(s + block, n)
        if dcsr is not None:
            xlm = dcsr.matmul(lm.T, s, e)                       # (r, L)
            d2 = (dcsr.row_sq_sums()[s:e, None] + lm_sq[None, :]
                  - 2.0 * xlm).clamp_(min=0.0)
        else:
            xb = (up.rows(s, e) if up is not None else
                  _as_device_f32(dense_rows(x, s, e) if host else x[s:e],
                                 device))
            d2 = pairwise_euclidean(xb, lm, squared=True)
        parts.append(_interp_weights_sparse(d2, min(k, L)) if sparse
                     else _interp_weights(d2, min(k, L), L))
        if verbose:
            print(f'landmark weights: rows [{e}/{n}] '
                  f'{time.perf_counter() - t0:.1f}s', flush=True)
    if sparse:
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return torch.cat(parts)


def landmark_correspondence(
    X, Y,
    n_landmarks: int = 2048,
    k_interp: int = 8,
    distance_mode: str = 'euclidean',
    seed: int = 666,
    kmax: int = 40,
    selection: str = 'fps',
    factor_layout: str = 'auto',
    device=None,
    mesh=None,
    **prime_dual_kwargs,
) -> LowRankF:
    """Low-rank unsupervised correspondence between datasets X (N0, f0) and
    Y (N1, f1): dense host arrays, scipy CSR matrices or tensors.
    `prime_dual_kwargs` forward to the exact solver (epoch_pd, rho,
    epsilon, delay, log_pd, verbose, precision, state_dtype).
    selection: 'fps' (farthest-point cover, default) or 'uniform'.
    factor_layout: 'dense' -> LowRankF (U = A_x F_L materialized, N x L),
    'sparse' -> SparseLandmarkF (k-sparse A factors, O(N k) memory),
    'auto' -> sparse once max(N) x L crosses _SPARSE_FACTOR_ENTRIES.
    mesh: the (L0, L1) solve's state rows shard over its 'data' axis
    (jamie_tpu/solvers/landmark.py:238); the rest runs on every rank."""
    if factor_layout not in ('auto', 'dense', 'sparse'):
        raise ValueError(f'unknown factor_layout {factor_layout!r}')
    device = resolve_device(device)
    n0, n1 = int(X.shape[0]), int(Y.shape[0])
    L0, L1 = min(int(n_landmarks), n0), min(int(n_landmarks), n1)

    # each stage a span that waits for the card before it closes; its
    # counters name the route and the sizes, one entry a modality where
    # the modalities differ
    with timing.span('landmark.selection', sync=True, L=[L0, L1],
                     rows=[n0, n1]) as selected:
        rng = np.random.RandomState(seed)
        (ox, rx), (oy, ry) = (_pick_landmarks(A, L, selection, rng, device)
                              for A, L in ((X, L0), (Y, L1)))
        lx, ly = np.sort(ox), np.sort(oy)
        selected.set(route=[rx, ry])
        # fancy row indexing of a CSR gathers just the landmark rows
        Xl, Yl = (A[idx].toarray() if is_scipy_sparse(A) else A[idx]
                  for A, idx in ((X, lx), (Y, ly)))

    # Exact solver on the landmark subproblem; graph modes (geodesic) run
    # on the landmark subset's own graph
    with timing.span('landmark.distances', sync=True, mode=distance_mode,
                     L=[L0, L1], features=[int(X.shape[1]), int(Y.shape[1])]
                     ) as distances:
        Kx = dataset_distance_matrix(Xl, distance_mode, kmax=kmax,
                                     device=device)
        Ky = dataset_distance_matrix(Yl, distance_mode, kmax=kmax,
                                     device=device)
    with timing.span('landmark.solve', sync=True, shape=[L0, L1],
                     state_dtype=prime_dual_kwargs.get('state_dtype',
                                                       'float32'),
                     iterations=int(prime_dual_kwargs.get('epoch_pd', 2000))
                     ) as solve:
        F_L = prime_dual(Kx, Ky, dx=int(X.shape[1]), dy=int(Y.shape[1]),
                         device=device, mesh=mesh, **prime_dual_kwargs)

    if factor_layout == 'auto':
        factor_layout = ('sparse' if max(n0, n1) * max(L0, L1)
                         > _SPARSE_FACTOR_ENTRIES else 'dense')
    with timing.span('landmark.weights', sync=True,
                     layout=factor_layout) as weights:
        if factor_layout == 'sparse':
            ix, wx = _cell_to_landmark_weights(X, Xl, k_interp, sparse=True,
                                               device=device)
            iy, wy = _cell_to_landmark_weights(Y, Yl, k_interp, sparse=True,
                                               device=device)
            F = SparseLandmarkF(ix, wx, iy, wy, F_L)
        else:
            A_x = _cell_to_landmark_weights(X, Xl, k_interp, device=device)
            A_y = _cell_to_landmark_weights(Y, Yl, k_interp, device=device)
            # U carries the solved landmark correspondences mixed by each
            # row cell's weights; V is the column side's affinity
            F = LowRankF(A_x @ F_L, A_y)
    F.landmarks = LandmarkSolve((lx, ly), (ox, oy), (Kx, Ky), F_L)
    if prime_dual_kwargs.get('verbose', True) and cm.is_rank0():
        print('landmark correspondence seconds: ' + ', '.join(
            f'{sp.name.split(".")[1]} {sp.seconds:.3f}'
            for sp in (selected, distances, solve, weights)))
    return F
