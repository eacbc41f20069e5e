"""The plain reference of the landmark route's stages: how JAMIE's
correspondence reaches an atlas, F = (A_x F_L) A_y^T from L landmark
cells a modality, and PCA of a CSR modality.

Plain PyTorch and numpy, written from the method (farthest-point
sampling on a Johnson-Lindenstrauss sketch, UnionCom's prime-dual F on
the landmarks' distances, row-stochastic kNN-Gaussian weights of each
cell over its nearest landmarks) on the benchmark's own CSR data. It
imports nothing of the program; matmuls run with TF32 off
(`reference.plain_matmuls`), and every product of a stage is in float64
on operands rounded to the stage's precision (`reference.rounding`).
No (N, N) matrix of either arm is formed:

- `draws`: each modality's first pick and its sketch's projection, drawn
  from one `numpy.random.RandomState(seed)` in the published order (the
  first pick, then the projection, modality by modality); the sketch
  replaces the rows past `FPS_BYTES` of float32;
- `sketch`: the rows FPS runs on, X P / sqrt(dim) as a float64 SpMM on
  the CSR, or the rows themselves under the budget;
- `geodesic`: the landmarks' kNN-graph shortest paths (`reference.
  geodesic`, with the kNN picks of numpy's `argpartition`);
- `fps`, `fps_check`: farthest-point sampling, and the test of a given
  pick order: at each step the pick's squared distance to the picks
  before it lies within `FPS_TOL` (relative) of the farthest remaining
  cell's;
- `weights`: the (n, L) kNN-Gaussian weights from float64 squared
  distances of every cell to the landmark rows (an SpMM Gram in
  `BLOCK`-row blocks): each row's k nearest landmarks, weights
  exp(-d2 / mean of their d2), normalized;
- `lowrank_gap`: ||U V^T - U' V'^T||_F / ||U' V'^T||_F from (L, L) Gram
  products in float64;
- `pca_basis`: the top-r left singular subspace of a CSR's centred rows
  by subspace iteration with the CSR and its transpose as operators.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

import reference as ref

# The sketch's width, and the float32 bytes of a modality past which FPS
# runs on the sketch (the published route: JAMIE's landmark selection)
SKETCH_DIM = 256
FPS_BYTES = 2 << 30
# A pick whose squared distance to the picks before it is at least
# (1 - FPS_TOL) of the farthest cell's passes: the program's float32
# sketch and distances read at most 2.4e-7, picks on a sketch of
# fp8-rounded rows at least 0.0156 (PERF.md)
FPS_TOL = 1e-4
# Rows of a block of cell-to-landmark distances
BLOCK = 8192


def _index_dtype(*sizes: int):
    return torch.int32 if max(sizes) < 2 ** 31 - 1 else torch.int64


def csr_parts(x, device, rnd: ref.Round = None):
    """(crow on the host, col, float64 values on `device`) of a scipy CSR
    matrix, the values rounded by `rnd` in float32 first (fp8 with the
    whole matrix's scale)."""
    if not x.has_canonical_format:
        x = x.copy()
        x.sum_duplicates()
    crow = np.asarray(x.indptr, np.int64)
    idt = _index_dtype(int(crow[-1]), *x.shape)
    col = torch.as_tensor(np.asarray(x.indices), device=device).to(idt)
    vals = torch.as_tensor(np.asarray(x.data, np.float32), device=device)
    if rnd is not None and vals.numel():
        vals = rnd(vals)
    return crow, col, vals.double()


def csr_rows(parts, shape, s: int, e: int) -> torch.Tensor:
    """Rows [s, e) of `csr_parts` as a float64 sparse CSR tensor."""
    crow, col, vals = parts
    a, b = int(crow[s]), int(crow[e])
    c = torch.as_tensor(crow[s:e + 1] - crow[s], device=vals.device).to(
        col.dtype)
    return torch.sparse_csr_tensor(c, col[a:b], vals[a:b],
                                   size=(e - s, shape[1]),
                                   check_invariants=False)


def _rounded(x, device, rnd: ref.Round, amax: Optional[float] = None):
    """A dense float32 array or tensor on `device` rounded by `rnd` (fp8
    with the scale of `amax`, the whole matrix's), in float64."""
    t = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x).to(device=device, dtype=torch.float32)
    if rnd is ref.round_fp8:
        t = ref.round_fp8(t, amax)
    elif rnd is not None:
        t = rnd(t)
    return t.double()


def amax(x) -> float:
    """The largest magnitude of a scipy matrix's values."""
    return float(np.abs(x.data).max()) if x.nnz else 0.0


# ------------------------------------------------------------ selection
def draws(seed: int, shapes):
    """[(first pick, projection or None)] per modality, from one
    RandomState(seed) in the published order."""
    rng = np.random.RandomState(seed)
    out = []
    for n, f in shapes:
        first = int(rng.randint(int(n)))
        proj = None
        if int(n) * int(f) * 4 > FPS_BYTES:
            proj = np.asarray(rng.randn(int(f), SKETCH_DIM).astype(np.float32)
                              / np.sqrt(SKETCH_DIM), np.float32)
        out.append((first, proj))
    return out


def sketch(x, proj, device, rnd: ref.Round = None) -> torch.Tensor:
    """The (n, d) float64 rows FPS runs on: the CSR x times `proj` with
    both rounded by `rnd`, or with no projection x's rounded rows."""
    n, f = x.shape
    top = amax(x)
    if proj is None:
        return _rounded(x.toarray(), device, rnd, top)
    p = _rounded(proj, device, rnd, float(np.abs(proj).max()))
    parts = csr_parts(x, device, rnd)
    return torch.cat([csr_rows(parts, x.shape, s, min(s + BLOCK, n)) @ p
                      for s in range(0, n, BLOCK)])


def _sq_to(s: torch.Tensor, j: int) -> torch.Tensor:
    return ((s - s[j]) ** 2).sum(1)


def fps(s: torch.Tensor, first: int, n_landmarks: int) -> np.ndarray:
    """Farthest-point sampling on the rows `s`: the picks in order, the
    first index of the largest squared distance at each step."""
    order = torch.empty(n_landmarks, dtype=torch.long, device=s.device)
    order[0] = first
    d = _sq_to(s, first)
    for k in range(1, n_landmarks):
        order[k] = torch.argmax(d)
        d = torch.minimum(d, _sq_to(s, int(order[k])))
    return order.cpu().numpy()


def fps_check(s: torch.Tensor, order, first: int,
              tol: float = FPS_TOL) -> dict:
    """Whether `order` is a farthest-point order on the rows `s`: its
    first pick is `first`, and at each step k the pick's squared distance
    to the picks before it is at least (1 - tol) of the farthest cell's.
    {'ok', 'worst' (the largest 1 - got / farthest), 'step' (where),
    'why'}."""
    order = torch.as_tensor(np.asarray(order), dtype=torch.long,
                            device=s.device)
    L = int(order.shape[0])
    if int(order[0]) != int(first):
        return {'ok': False, 'worst': math.inf, 'step': 0,
                'why': f'first pick {int(order[0])}, drawn {first}'}
    if int(torch.unique(order).numel()) != L:
        return {'ok': False, 'worst': math.inf, 'step': None,
                'why': 'a cell picked twice'}
    got = torch.empty(L - 1, dtype=s.dtype, device=s.device)
    far = torch.empty_like(got)
    d = _sq_to(s, int(first))
    for k in range(1, L):
        got[k - 1] = d[order[k]]
        far[k - 1] = d.max()
        d = torch.minimum(d, _sq_to(s, int(order[k])))
    short = torch.where(far > 0, 1.0 - got / far.clamp(min=1e-300),
                        torch.zeros_like(far))
    k = int(torch.argmax(short)) if L > 1 else 0
    worst = float(short[k]) if L > 1 else 0.0
    ok = worst <= tol
    return {'ok': ok, 'worst': worst, 'step': k + 1,
            'why': None if ok else
            f'pick {k + 1} lies {worst:.3g} short of the farthest cell'}


# ------------------------------------------------------------ distances
def geodesic(d: torch.Tensor, kmin: int = 5, kmax: int = 40, kstep: int = 5,
             tie: float = 0.0):
    """`reference.geodesic` with each row's k + 1 nearest (itself
    included) taken by numpy's `argpartition` on the float32 matrix, as
    the published kNN graph takes them: on binary rows whole groups of
    distances tie exactly (square roots of integers), and both sides
    then break them by the same rule on the same float32 values. Entries
    that a near tie (within `tie`, relative, and not equal) at a row's
    last kept neighbour moves are returned as undecided."""
    n = d.shape[0]
    host = d.float().cpu().numpy()
    bridged = False
    for k in range(kmin, max(kmax, kmin) + 1, kstep):
        k = min(k, n - 1)
        idx = torch.as_tensor(
            np.argpartition(host, min(k + 1, n - 1), axis=1)[:, :k + 1],
            device=d.device)
        adj = ref._knn_graph(d, idx)
        label = ref._components(adj)
        if bool((label == 0).all()):
            break
    else:
        adj = ref._bridge(adj, d, label)
        bridged = True
    g = ref._closure(adj)
    undecided = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    if tie > 0 and not bridged and k + 1 < n:
        near = torch.sort(d, dim=1).values[:, k:k + 2].double()
        gap = (near[:, 1] - near[:, 0]) / near[:, 0].clamp(min=1e-30)
        for r in torch.nonzero((gap > 0) & (gap < tie)).flatten().tolist():
            kept = idx[r]
            out = torch.ones(n, dtype=torch.bool, device=d.device)
            out[kept] = False
            other = idx.clone()
            other[r, int(torch.argmax(d[r, kept]))] = int(
                torch.nonzero(out).flatten()[torch.argmin(d[r, out])])
            moved = (ref._closure(ref._knn_graph(d, other)) - g).abs()
            undecided |= moved > 1e-9 * g.max()
    return g.float(), undecided


# -------------------------------------------------------------- weights
def weights(x, lm_rows: np.ndarray, k: int, device,
            rnd: ref.Round = None) -> torch.Tensor:
    """(n, L) float64 row-stochastic kNN-Gaussian weights of every cell of
    the CSR x over the landmark rows `lm_rows` (x's rows, dense), both
    rounded by `rnd`: squared distances |x|^2 + |l|^2 - 2 x.l by a
    float64 SpMM in `BLOCK`-row blocks, each row's k nearest, bandwidth
    their mean squared distance (at least 1e-12)."""
    n = x.shape[0]
    parts = csr_parts(x, device, rnd)
    lm = _rounded(lm_rows, device, rnd, amax(x))
    L = lm.shape[0]
    k = min(int(k), L)
    crow, col, vals = parts
    # each row's |x|^2 from its rounded values
    row = torch.repeat_interleave(
        torch.arange(n, device=device),
        torch.as_tensor(np.diff(crow), device=device))
    xsq = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
        0, row, vals * vals)
    lsq = (lm * lm).sum(1)
    a = torch.zeros((n, L), dtype=torch.float64, device=device)
    for s in range(0, n, BLOCK):
        e = min(s + BLOCK, n)
        d2 = (xsq[s:e, None] + lsq[None, :]
              - 2.0 * (csr_rows(parts, x.shape, s, e) @ lm.T)).clamp_(min=0)
        knn, idx = torch.topk(d2, k, dim=1, largest=False)
        bw = knn.mean(1, keepdim=True).clamp(min=1e-12)
        w = torch.exp(-knn / bw)
        a[s:e].scatter_(1, idx, w / w.sum(1, keepdim=True))
    return a


# ------------------------------------------------------------------ F
def lowrank_gap(u, v, u_ref, v_ref) -> float:
    """||U V^T - U' V'^T||_F / ||U' V'^T||_F in float64 from (L, L) Grams:
    ||U V^T||^2 = sum((U^T U) * (V^T V)), <U V^T, U' V'^T> = sum((U^T U')
    * (V^T V'))."""
    dev = u_ref.device
    u, v = (torch.as_tensor(t).to(dev).double() for t in (u, v))
    u_ref, v_ref = u_ref.double(), v_ref.double()
    gg = torch.sum((u.T @ u) * (v.T @ v))
    rr = torch.sum((u_ref.T @ u_ref) * (v_ref.T @ v_ref))
    gr = torch.sum((u.T @ u_ref) * (v.T @ v_ref))
    return float(torch.sqrt(torch.clamp(gg + rr - 2.0 * gr, min=0.0) / rr))


# ------------------------------------------------------------------ PCA
def pca_basis(x, r: int, device, rnd: ref.Round = None, iters: int = 16,
              seed: int = 0):
    """(orthonormal (n, r) basis, Ritz values largest first) of the top-r
    left singular subspace of the CSR x's centred rows (values rounded by
    `rnd`), as `reference.pca_subspace` finds it from their Gram: subspace
    iteration with 2r vectors on Xc Xc^T, applied as Xc (Xc^T Q) with the
    CSR and its transpose, then Rayleigh-Ritz; all in float64."""
    n, f = x.shape
    parts = csr_parts(x, device, rnd)
    X = csr_rows(parts, x.shape, 0, n)
    csc = X.to_sparse_csc()
    Xt = torch.sparse_csr_tensor(csc.ccol_indices(), csc.row_indices(),
                                 csc.values(), size=(f, n),
                                 check_invariants=False)
    del csc
    mean = (Xt @ torch.ones((n, 1), dtype=torch.float64,
                            device=device))[:, 0] / n

    def xc(M):          # Xc M, (n, k)
        return X @ M - (mean @ M)[None, :]

    def xct(Q):         # Xc^T Q, (f, k)
        return Xt @ Q - mean[:, None] * Q.sum(0)[None, :]

    k = min(2 * r, n, f)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((n, k), generator=gen, device=device,
                    dtype=torch.float64)
    q, _ = torch.linalg.qr(q)
    for _ in range(iters):
        q, _ = torch.linalg.qr(xc(xct(q)))
    b = xct(q)
    w, v = torch.linalg.eigh(b.T @ b)
    order = torch.argsort(w, descending=True)
    return q @ v[:, order[:r]], w[order]
