"""Invertible preprocessing: PCA projection + fit-sample standardization.

Reference parity: `jamie_tpu/preprocess.py` — `PCA` with the `_pca_fit`
routing (:276-323), `_component_signs` (:267-273) and `Preprocessor`
(:506-680), the reference's `preclass` (jamie/utilities.py:654-678): PCA to
`pca_dim` then scalar standardization, or per-feature standardization
without PCA, NaN -> 0, fully invertible, with the same `to_dict` keys so
checkpoints cross between the packages.

PCA routes, chosen as jamie_tpu chooses them (`_pca_fit_host`):

- up to `_STREAM_THRESHOLD` elements (compared with `>`): the exact
  Gram/covariance eigh (`_pca_fit_direct`), or the Halko randomized range
  finder (`_pca_fit_randomized`) past `_RANDOMIZED_THRESHOLD`; a sparse
  source is shipped as CSR and decoded to exact f32 on the device;
- past it, the matrix is rounded to bf16: `_pca_fit_resident_bf16` from
  the shared bf16 residency (`core/residency.device_bf16`) while it fits
  the budget, else `_pca_fit_streamed` over column chunks (f > n) or
  `_pca_fit_row_streamed` over row blocks (the tall atlas case; a CSR
  source runs its sketch and projection as SpMMs on a `DeviceCSR`). These
  routes return the fit's scores as a device tensor, which
  `Preprocessor.transform_fit` standardizes on the device (one-shot).
  A CSR source whose `DeviceCSR` fits the budget takes the row-streamed
  route whatever its shape, where jamie_tpu streams a wide one's
  columns: that route converts the whole matrix to CSC on the host and
  decodes every column chunk dense on the device, 52.6-57.3 s of a
  69,249-cell fit at 116,490 ATAC columns (403M nonzeros; H100 80GB HBM3,
  700.00 W), where the SpMMs on the resident CSR take seconds.

Every matmul is torch on `device` (the card unless the caller asks for
another): the products are plain large GEMMs or library SpMMs that
jamie_tpu leaves to XLA. Omega comes from a `torch.Generator`, so a sketch
differs from jamie_tpu's (a jax key) while the subspace it finds agrees.

`NonlinearEmbedding` is the t-SNE/UMAP preclass (`jamie_tpu/preprocess.py:
444-503`), with jamie_tpu's kNN out-of-sample extension in both directions
through K3 cross distances.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .core import residency, timing
from .core.dtypes import bf16_matmul, resolve_device
from .core.hostmat import (as_f32_ndarray, dense_rows, densify,
                           ensure_col_major, is_scipy_sparse)

# Past this many elements (compared with `>`) PCA takes the bf16-resident
# or streamed routes (preprocess.py:32). The one bf16 pivot, kept for the
# reason core/residency.BF16_LINK_ELEMS states. Read at call time.
_STREAM_THRESHOLD = 100_000_000

# Above this many cells (and with n_components <= min(n, f) // 4) the
# randomized range finder replaces the full eigh (preprocess.py:37)
_RANDOMIZED_THRESHOLD = 4096

# Row-block size of the row-streamed PCA's SpMM sketch (preprocess.py:43).
# A block size, not a route: kept, as the `residency` probe timed 16,384-row
# blocks and whole-matrix SpMMs alike (H100 80GB HBM3, 700.00 W). Read at
# call time.
_SKETCH_SPMM_ROWS = 65_536

# Feature columns per f32 chunk when a product reads a bf16 matrix
# exactly (Q^T X): bounds the f32 copy at this many bytes
_F32_CHUNK_BYTES = 1 << 30


def _pca_fit_randomized(X: torch.Tensor, n_components: int,
                        oversample: int = 10, power_iters: int = 2,
                        seed: int = 0):
    """Halko-style randomized PCA: tall matmuls plus a small eigh."""
    n, f = X.shape
    k = min(n_components + oversample, min(n, f))
    mean = X.mean(0)
    Xc = X - mean
    gen = torch.Generator(device=X.device).manual_seed(seed)
    omega = torch.randn((f, k), generator=gen, device=X.device,
                        dtype=torch.float32)
    Q, _ = torch.linalg.qr(Xc @ omega)
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Xc @ (Xc.T @ Q))
    B = Q.T @ Xc                                   # (k, f)
    w, Ub = torch.linalg.eigh(B @ B.T)
    Ub = Ub.flip(1)[:, :n_components]
    s = torch.sqrt(torch.clamp(w.flip(0)[:n_components], min=1e-12))
    return mean, (Ub / s).T @ B                    # (n_components, f)


# The Gram route's rank cut, in eps of the largest eigenvalue. The float32
# Gram's null-space eigenvalues came out within 1 eps of it (300 cells with
# 150 repeated, SNARE-like 1047 x 3000); the smallest genuine ones of
# SNARE-like RNA sit at 43 eps, and an n eps cut (n = 1047) zeroed 336 of
# its 512 leading components.
_GRAM_RANK_EPS = 8


def _pca_fit_direct(X: torch.Tensor, n_components: int):
    """Exact PCA (Gram route for tall-feature matrices).

    The n centred rows span at most n - 1 directions, fewer where rows
    repeat, so with n_components near n (pca_dim at or above the cell
    count, the Gram route) the last components lie in their null space:
    their eigenvalues are rounding, and S^-1 U^T Xc would amplify that
    rounding into columns that carry most of the standardized variance.
    Such components are zero here, as an SVD gives them a zero singular
    value and zero scores (sklearn's PCA in the reference JAMIE): those
    from index n - 1 on and those whose eigenvalue is at most
    _GRAM_RANK_EPS eps w_max, the float32 Gram's own rounding. jamie_tpu
    keeps them
    (`_pca_fit_direct`, preprocess.py:327-345), a fault not carried over:
    whether its columns blow up depends on the rounding of the
    eigenvalues."""
    n, f = X.shape
    mean = X.mean(0)
    Xc = X - mean
    if f > n:
        # Gram route: Xc Xc^T = U S^2 U^T; components = S^-1 U^T Xc
        w, U = torch.linalg.eigh(Xc @ Xc.T)        # ascending
        w = w.flip(0)[:n_components]
        U = U.flip(1)[:, :n_components]
        s = torch.sqrt(torch.clamp(w, min=1e-12))
        comps = (U / s).T @ Xc                     # (k, F)
        # the centred null space
        cut = _GRAM_RANK_EPS * torch.finfo(w.dtype).eps * w[0]
        null = (w <= cut) | (torch.arange(len(w), device=w.device) >= n - 1)
        comps = torch.where(null[:, None], 0.0, comps)
    else:
        _, V = torch.linalg.eigh(Xc.T @ Xc)
        comps = V.flip(1)[:, :n_components].T
    return mean, comps


def _component_signs(comps: torch.Tensor) -> torch.Tensor:
    """sklearn svd_flip style: the largest-|.| entry of each component is
    made positive."""
    idx = torch.argmax(comps.abs(), dim=1)
    signs = torch.sign(comps[torch.arange(comps.shape[0]), idx])
    return torch.where(signs == 0, torch.ones_like(signs), signs)


def _pca_fit(X: torch.Tensor, n_components: int):
    """(mean, sign-fixed components[k, F]) of a tensor by jamie_tpu's
    in-memory routing: exact eigh, or randomized past the threshold."""
    n, f = X.shape
    if (min(n, f) > _RANDOMIZED_THRESHOLD
            and n_components <= min(n, f) // 4):
        timing.note(route='pca_randomized')
        mean, comps = _pca_fit_randomized(X, n_components)
    else:
        timing.note(route='pca_direct')
        mean, comps = _pca_fit_direct(X, n_components)
    return mean, comps * _component_signs(comps)[:, None]


def _qt_x(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Q^T X for an f32 Q and a bf16 X, with X read exactly (as jamie_tpu's
    f32 x bf16 matmul promotes it) in column chunks: no f32 copy of the
    whole matrix."""
    cols = max(_F32_CHUNK_BYTES // max(4 * X.shape[0], 1), 1)
    return torch.cat([Q.T @ X[:, s:s + cols].float()
                      for s in range(0, X.shape[1], cols)], dim=1)


def _eig_finish(B: torch.Tensor, Q: torch.Tensor, n_components: int):
    """Components and the fit's scores from the projection B = Q^T Xc:
    the top right-singular vectors of B, and Xc comps^T ~ Q Ub s."""
    w, Ub = torch.linalg.eigh(B @ B.T)
    Ub = Ub.flip(1)[:, :n_components]
    s = torch.sqrt(torch.clamp(w.flip(0)[:n_components], min=1e-12))
    return (Ub / s).T @ B, Q @ (Ub * s)


def _pca_fit_resident_bf16(X: torch.Tensor, n_components: int,
                           oversample: int = 10, seed: int = 0,
                           power_iters: int = 1):
    """Randomized PCA straight from a device-resident bf16 matrix, with
    `power_iters` power iterations (jamie_tpu runs one). Centering is
    implicit, (X - 1 mean^T) M = X M - 1 (mean^T M), so no f32 or centered
    copy of X exists; X @ M runs with bf16 operands and an f32 result,
    Q^T X reads X exactly. Returns (mean, components, fit scores)."""
    n, f = X.shape
    k = min(n_components + oversample, n)
    mean = X.sum(0, dtype=torch.float32) / n                  # (f,)
    gen = torch.Generator(device=X.device).manual_seed(seed)
    omega = torch.randn((f, k), generator=gen, device=X.device,
                        dtype=torch.float32)
    Y = bf16_matmul(X, omega) - (mean @ omega)[None, :]
    Q, _ = torch.linalg.qr(Y)                                 # (n, k)
    for _ in range(power_iters):
        Zt = _qt_x(Q, X) - Q.sum(0)[:, None] * mean[None, :]  # (k, f)
        Y = bf16_matmul(X, Zt.T) - (mean @ Zt.T)[None, :]
        Q, _ = torch.linalg.qr(Y)
    B = _qt_x(Q, X) - Q.sum(0)[:, None] * mean[None, :]       # (k, f)
    return (mean, *_eig_finish(B, Q, n_components))


def _pca_fit_streamed(X, n_components: int, oversample: int = 10,
                      seed: int = 0, device=None):
    """Randomized PCA with the feature axis streamed from the host, for
    wide matrices too large to keep whole (e.g. 9.2k x 242k ATAC past the
    budget). Two passes over column chunks (`residency.ChunkUploader`;
    sparse X should arrive CSC): the sketch Y = sum_b Xc_b Omega_b with the
    column means, then the projection B = Q^T Xc, kept on the device."""
    device = resolve_device(device)
    n, f = (int(d) for d in X.shape)
    k = min(n_components + oversample, n)
    chunk = max(int((1 << 30) / (n * 4)), 1024)
    gen = torch.Generator(device=device).manual_seed(seed)
    up = residency.ChunkUploader(X, device)
    means = []
    Y = torch.zeros((n, k), dtype=torch.float32, device=device)
    for s in range(0, f, chunk):
        xb = up.cols(s, s + chunk)
        mb = xb.mean(0)
        omega_b = torch.randn((xb.shape[1], k), generator=gen, device=device,
                              dtype=torch.float32)
        Y += (xb - mb) @ omega_b
        means.append(mb)
    Q, _ = torch.linalg.qr(Y)
    parts = []
    for s in range(0, f, chunk):
        xb = up.cols(s, s + chunk)
        parts.append(Q.T @ (xb - xb.mean(0)))
    comps, scores = _eig_finish(torch.cat(parts, dim=1), Q, n_components)
    return torch.cat(means), comps, scores


def _pca_fit_row_streamed(X, n_components: int, oversample: int = 10,
                          seed: int = 0, chunk_bytes: int = 1 << 30,
                          power_iters: int = 1, device=None):
    """Randomized PCA with the CELL axis streamed, for tall matrices (n >
    f) too large to be resident, e.g. 100k cells x 40k ATAC peaks. The
    matrix is read in row blocks for the sketch, each power iteration (two
    passes) and the projection; the scores come from the final range. A
    CSR source that fits the budget runs these as SpMMs on its DeviceCSR
    (the sketch in `_SKETCH_SPMM_ROWS` row blocks, the projection through
    the transposed twin, released afterwards)."""
    device = resolve_device(device)
    n, f = (int(d) for d in X.shape)
    k = min(n_components + oversample, min(n, f))
    rows = max(int(chunk_bytes / max(f * 4, 1)), 256)
    up = residency.ChunkUploader(X, device)

    # Column means: scipy's sparse mean is O(nnz); dense in f64 row blocks
    if is_scipy_sparse(X):
        mean_np = np.asarray(X.mean(axis=0), np.float32).ravel()
    else:
        acc = np.zeros((f,), np.float64)
        for s in range(0, n, rows):
            acc += dense_rows(X, s, s + rows).sum(axis=0, dtype=np.float64)
        mean_np = (acc / n).astype(np.float32)
    mean = torch.as_tensor(mean_np, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    omega = torch.randn((f, k), generator=gen, device=device,
                        dtype=torch.float32)
    dcsr = up.dcsr

    def sketch(M):
        """Y = Xc M, (n, k) on the device, in row blocks."""
        mo = (mean @ M)[None, :]
        step = _SKETCH_SPMM_ROWS if dcsr is not None else rows
        blk = ((lambda s: dcsr.matmul(M, s, s + step)) if dcsr is not None
               else (lambda s: up.rows(s, s + step) @ M))
        return torch.cat([blk(s) - mo for s in range(0, n, step)])

    def project(Q):
        """B = Q^T Xc, (k, f) on the device."""
        B = -Q.sum(0)[:, None] * mean[None, :]
        if dcsr is not None:
            return B + dcsr.tmatmul(Q).T
        for s in range(0, n, rows):
            B = B + Q[s:s + rows].T @ up.rows(s, s + rows)
        return B

    Q, _ = torch.linalg.qr(sketch(omega))
    for _ in range(power_iters):      # each iteration = 2 more data passes
        Q, _ = torch.linalg.qr(sketch(project(Q).T))
    B = project(Q)
    if dcsr is not None:
        dcsr.release_csc()
    return (mean, *_eig_finish(B, Q, n_components))


def _pca_fit_host(X, n_components: int, power_iters: int = 1, device=None):
    """(mean, sign-fixed components[k, F], fit scores or None) of a host
    matrix (dense or scipy-sparse) by jamie_tpu's `_pca_fit` routing.
    power_iters applies to the bf16-resident and row-streamed routes
    (jamie_tpu's to the row-streamed route only, its resident route runs
    one)."""
    device = resolve_device(device)
    sparse_in = is_scipy_sparse(X)
    n, f = (int(d) for d in X.shape)
    if n * f > _STREAM_THRESHOLD:
        xdev = residency.device_bf16(X, device=device)
        if xdev is not None:
            timing.note(route='pca_resident_bf16')
            mean, comps, scores = _pca_fit_resident_bf16(
                xdev, n_components, power_iters=power_iters)
        elif f > n and residency.device_csr(X, device=device) is None:
            timing.note(route='pca_streamed')
            mean, comps, scores = _pca_fit_streamed(
                ensure_col_major(X), n_components, device=device)
        else:
            timing.note(route='pca_row_streamed')
            mean, comps, scores = _pca_fit_row_streamed(
                X, n_components, power_iters=power_iters, device=device)
        signs = _component_signs(comps)
        return mean, comps * signs[:, None], scores * signs[None, :]
    Xt = (residency.csr_to_device(X, device) if sparse_in
          else torch.as_tensor(X, device=device))
    mean, comps = _pca_fit(Xt, n_components)
    return mean, comps, None


class PCA:
    """Minimal sklearn-compatible PCA whose linear algebra runs on
    `device`. `mean_` and `components_` are device tensors; `scores_` holds
    the fit data's projection where the fit route computes it (the
    bf16-resident and streamed routes), as a device tensor. Transforms take
    host arrays (dense or scipy-sparse) and return host arrays."""

    def __init__(self, n_components: int, device=None, power_iters: int = 1):
        self.n_components = int(n_components)
        self.power_iters = int(power_iters)
        self.device = resolve_device(device)
        self.mean_: Optional[torch.Tensor] = None
        self.components_: Optional[torch.Tensor] = None
        self.scores_: Optional[torch.Tensor] = None

    def fit(self, X):
        if not is_scipy_sparse(X):
            X = as_f32_ndarray(X)
        self.mean_, self.components_, self.scores_ = _pca_fit_host(
            X, self.n_components, self.power_iters, self.device)
        return self

    def transform(self, X, row_chunk_bytes: int = 2 << 30) -> np.ndarray:
        """(X - mean) @ components^T. Small dense inputs go whole and
        exact; larger ones in row blocks, through `residency.ChunkUploader`
        from `_STREAM_THRESHOLD` elements on (compared with `>=`), and a
        resident CSR by SpMM (jamie_tpu/preprocess.py:396-429). Past the
        whole route a `pca.transform` span names the route taken."""
        sparse_in = is_scipy_sparse(X)
        if not sparse_in:
            X = as_f32_ndarray(X)
        n, f = (int(d) for d in X.shape)
        comps_t = self.components_.T
        if n * f * 4 <= row_chunk_bytes and not sparse_in:
            Xt = torch.as_tensor(X, device=self.device)
            return ((Xt - self.mean_) @ comps_t).cpu().numpy()
        rows = max(int(row_chunk_bytes / (f * 4)), 64)
        up = (residency.ChunkUploader(X, self.device)
              if n * f >= _STREAM_THRESHOLD else None)
        spmm = up is not None and up.dcsr is not None
        with timing.span('pca.transform', route=(
                'pca_transform_spmm' if spmm else
                'pca_transform_uploader' if up is not None else None)):
            if spmm:
                mproj = (self.mean_ @ comps_t)[None, :]
                return np.concatenate([
                    (up.dcsr.matmul(comps_t, s, s + rows) - mproj)
                    .cpu().numpy() for s in range(0, n, rows)])

            def block(s):
                if up is not None:
                    return up.rows(s, s + rows)
                return torch.as_tensor(dense_rows(X, s, s + rows),
                                       device=self.device)
            return np.concatenate([((block(s) - self.mean_) @ comps_t)
                                   .cpu().numpy() for s in range(0, n, rows)])

    def fit_transform(self, X):
        """The fit's scores where the route computed them (a device
        tensor), else transform(X) (a host array)."""
        self.fit(X)
        return self.scores_ if self.scores_ is not None else self.transform(X)

    def inverse_transform(self, Y) -> np.ndarray:
        Yt = torch.as_tensor(np.asarray(Y, np.float32), device=self.device)
        return (Yt @ self.components_ + self.mean_).cpu().numpy()


class NonlinearEmbedding:
    """t-SNE / UMAP preclass front end (model_pca='tsne'/'umap',
    jamie/jamie.py:444-451) with jamie_tpu's kNN out-of-sample extension:
    transform maps new rows through their k nearest fit rows in input
    space, inverse_transform through the nearest rows in embedding space,
    each an inverse-squared-distance weighted average, so modal_predict
    works under a nonlinear preclass. The fit data and embedding are host
    arrays (the checkpoint keys `nle_fit_data`, `nle_embedding`)."""

    K_NEIGHBORS = 10

    def __init__(self, n_components: int, method: str = 'tsne', device=None):
        self.n_components = int(n_components)
        self.method = method
        self.device = resolve_device(device)
        self.fit_data_: Optional[np.ndarray] = None
        self.embedding_: Optional[np.ndarray] = None

    def fit_transform(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        if self.method == 'umap':
            from .solvers.umap import umap_embed
            emb = umap_embed(X, self.n_components, device=self.device)
        else:
            from .solvers.tsne import tsne_embed
            perplexity = float(min(30.0, max(2.0, (X.shape[0] - 1) / 3)))
            emb = tsne_embed(X, self.n_components, perplexity=perplexity,
                             device=self.device)
        self.fit_data_ = X
        self.embedding_ = np.asarray(emb, np.float32)
        return self.embedding_

    def _knn_interpolate(self, queries, keys, values) -> np.ndarray:
        """Inverse-squared-distance weighted average of `values` over each
        query's k nearest rows of `keys` (an exact match returns its value,
        up to the 1e-12 floor); the squared distances are K3's."""
        from .ops.pairwise import pairwise_euclidean
        dev = self.device
        q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
        kt = torch.as_tensor(np.asarray(keys, np.float32), device=dev)
        vt = torch.as_tensor(np.asarray(values, np.float32), device=dev)
        d2 = pairwise_euclidean(q.contiguous(), kt.contiguous(), squared=True)
        neg_d2, idx = torch.topk(-d2, min(self.K_NEIGHBORS, kt.shape[0]),
                                 dim=1)
        w = 1.0 / torch.clamp(-neg_d2, min=1e-12)
        w /= w.sum(1, keepdim=True)
        return torch.einsum('nk,nkd->nd', w, vt[idx]).cpu().numpy()

    def transform(self, X) -> np.ndarray:
        assert self.fit_data_ is not None, 'embedding not fit yet'
        return self._knn_interpolate(X, self.fit_data_, self.embedding_)

    def inverse_transform(self, Y) -> np.ndarray:
        assert self.fit_data_ is not None, 'embedding not fit yet'
        return self._knn_interpolate(Y, self.embedding_, self.fit_data_)


class Preprocessor:
    """preclass-equivalent: [PCA ->] standardize by fit-sample stats.

    axis: None standardizes by the scalar mean/std of the whole transformed
    sample (the PCA path, jamie.py:453); 0 standardizes per feature (the
    no-PCA path, jamie.py:455,462-465).
    """

    def __init__(self, sample=None, pca: Optional[PCA] = None,
                 axis: Optional[int] = None):
        self.pca = pca
        self.axis = axis
        if sample is None:
            self.sample_mean = None
            self.sample_std = None
        elif isinstance(sample, torch.Tensor):
            # device fit sample (the large PCA routes' scores): fetch only
            # the statistics, never the sample
            kw = {} if axis is None else {'dim': axis}
            self.sample_mean = sample.mean(**kw).cpu().numpy()
            self.sample_std = sample.std(correction=0, **kw).cpu().numpy()
        else:
            sample = np.asarray(sample, np.float32)
            self.sample_mean = np.asarray(sample.mean(axis), np.float32)
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                self.sample_std = np.asarray(sample.std(axis), np.float32)

    @classmethod
    def fit(cls, data, pca_dim: Optional[int] = None, method: str = 'pca',
            device=None, power_iters: int = 1) -> 'Preprocessor':
        """Build the per-modality preprocessor as project_jamie does
        (jamie/jamie.py:436-465): PCA (or, for method 'umap'/'tsne', a
        NonlinearEmbedding) to pca_dim (clamped, with a warning) then
        scalar standardization; or per-feature standardization.
        scipy-sparse data streams through the PCA routes; without pca_dim,
        or into a nonlinear embedding, it is densified, with a warning past
        1e9 elements in the first case."""
        if is_scipy_sparse(data):
            if pca_dim is None:
                if data.shape[0] * data.shape[1] > 1_000_000_000:
                    warnings.warn(
                        'sparse input without pca_dim densifies '
                        f'{data.shape} on host; set pca_dim to keep the '
                        'pipeline streaming', UserWarning)
                data = densify(data)
        else:
            data = as_f32_ndarray(data)
        if pca_dim is not None:
            dim = int(pca_dim)
            if min(*data.shape) < dim:
                warnings.warn(
                    f'PCA dim must be lower than {min(*data.shape)}, found '
                    f'{dim}, adjusting to compensate.')
                dim = min(*data.shape)
            if method in ('umap', 'tsne'):
                pca = NonlinearEmbedding(dim, method=method, device=device)
                data = densify(data) if is_scipy_sparse(data) else data
            else:
                pca = PCA(n_components=dim, device=device,
                          power_iters=power_iters)
            sample = pca.fit_transform(data)
            pre = cls(sample, pca=pca, axis=None)
            pre._fit_sample = sample
            return pre
        pre = cls(data, axis=0)
        pre._fit_sample = data
        return pre

    def _standardize(self, out) -> np.ndarray:
        out = np.array(out, np.float32)
        out = out - self.sample_mean
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            out = out / self.sample_std
        out[np.isnan(out)] = 0
        return out

    def transform_fit(self):
        """Standardized transform of the data this preprocessor was fit on,
        from the cached fit sample (no second projection).

        A device fit sample is standardized on the device, in place, and
        handed on as a tensor: ONE-SHOT by design (jamie_tpu donates the
        buffer; keeping it would double peak device memory at atlas
        scale), so the raw sample is gone afterwards and a second call
        raises. The host path is repeatable."""
        sample = getattr(self, '_fit_sample', None)
        if sample is None:
            raise RuntimeError(
                'transform_fit: the device fit sample was already consumed '
                '(the device path standardizes in place and is one-shot by '
                'design; call transform(X) to re-project instead)')
        if isinstance(sample, torch.Tensor):
            out = sample.sub_(float(self.sample_mean)).div_(
                float(self.sample_std))
            out.masked_fill_(torch.isnan(out), 0.0)
            self._fit_sample = None
            if self.pca is not None:
                self.pca.scores_ = None
            return out
        return self._standardize(sample)

    def transform(self, X) -> np.ndarray:
        if is_scipy_sparse(X):
            # PCA.transform streams sparse rows itself
            out = X if isinstance(self.pca, PCA) else densify(X)
        else:
            out = as_f32_ndarray(X)
        if self.pca is not None:
            out = self.pca.transform(out)
        return self._standardize(out)

    def inverse_transform(self, X) -> np.ndarray:
        out = np.asarray(X, np.float32)
        out = out * self.sample_std
        out = out + self.sample_mean
        if self.pca is not None:
            out = self.pca.inverse_transform(out)
        return out

    # --- checkpointable state (same keys as jamie_tpu) ---
    def to_dict(self) -> dict:
        d = {
            'axis': -1 if self.axis is None else self.axis,
            'sample_mean': self.sample_mean,
            'sample_std': self.sample_std,
        }
        if isinstance(self.pca, NonlinearEmbedding):
            d['nle_fit_data'] = self.pca.fit_data_
            d['nle_embedding'] = self.pca.embedding_
            d['nle_method'] = np.array(self.pca.method)
        elif self.pca is not None:
            d['pca_mean'] = self.pca.mean_.cpu().numpy()
            d['pca_components'] = self.pca.components_.cpu().numpy()
        return d

    @classmethod
    def from_dict(cls, d: dict, device=None) -> 'Preprocessor':
        self = cls.__new__(cls)
        axis = int(d['axis'])
        self.axis = None if axis == -1 else axis
        self.sample_mean = np.asarray(d['sample_mean'])
        self.sample_std = np.asarray(d['sample_std'])
        if 'nle_embedding' in d:
            emb = np.asarray(d['nle_embedding'], np.float32)
            nle = NonlinearEmbedding(emb.shape[1],
                                     method=str(np.asarray(d['nle_method'])),
                                     device=device)
            nle.fit_data_ = np.asarray(d['nle_fit_data'], np.float32)
            nle.embedding_ = emb
            self.pca = nle
        elif 'pca_components' in d:
            comps = np.asarray(d['pca_components'], np.float32)
            pca = PCA(n_components=comps.shape[0], device=device)
            pca.mean_ = torch.tensor(np.asarray(d['pca_mean'], np.float32),
                                     device=pca.device)
            pca.components_ = torch.tensor(comps, device=pca.device)
            self.pca = pca
        else:
            self.pca = None
        return self


def identity(x):
    """Identity preprocessing (jamie/utilities.py:48-50)."""
    return x
