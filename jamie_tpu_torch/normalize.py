"""Count-matrix normalization: the standard single-cell transforms.

A copy of `jamie_tpu/normalize.py` (this package imports nothing of
`jamie_tpu`): plain host numpy/scipy functions, since normalization is one
O(nnz) pass over data read once; the device phases start after.

The depth-scaling family (`cpm`, `normalize_total`, `log1p`, `sqrt`,
`normalize_log_cpm`) preserves scipy-sparse inputs, so a CSR atlas can be
normalized and fed straight to `JAMIE.fit_transform`. The reference-free
factor methods (TMM/DESeq/UQ/quantile/Pearson residuals) need dense
statistics and densify internally.

Every function takes cells x features counts and returns the same shape.
"""

from __future__ import annotations

import numpy as np

from .core.hostmat import densify, is_scipy_sparse

__all__ = [
    'library_size', 'scale_rows', 'cpm', 'normalize_total', 'log1p',
    'sqrt', 'normalize_log_cpm', 'normalize_deseq', 'normalize_tmm',
    'normalize_upper_quartile', 'normalize_quantile', 'pearson_residuals',
    'zscore',
]


def library_size(x) -> np.ndarray:
    """Per-cell total counts, floored at 1 (zero rows scale by 1), (n, 1)."""
    if is_scipy_sparse(x):
        depth = np.asarray(x.sum(axis=1)).reshape(-1, 1)
    else:
        depth = np.asarray(x).sum(axis=1, keepdims=True)
    return np.maximum(depth, 1.0)


def scale_rows(x, factors):
    """x * factors[:, None], sparse-preserving. factors: (n,) or (n, 1).
    The result keeps x's float dtype (an f32 atlas must not silently
    double to f64); integer counts promote to f64."""
    out_dtype = x.dtype if np.issubdtype(x.dtype, np.floating) \
        else np.float64
    factors = np.asarray(factors, out_dtype).reshape(-1)
    if is_scipy_sparse(x):
        from scipy import sparse
        return (sparse.diags(factors) @ x.tocsr()).astype(out_dtype,
                                                          copy=False).tocsr()
    return np.asarray(x, out_dtype) * factors[:, None]


def _map_data(x, fn):
    """Elementwise zero-fixing map (fn(0) == 0), sparse-preserving."""
    if is_scipy_sparse(x):
        out = x.tocsr(copy=True)
        out.data = fn(out.data)
        return out
    return fn(np.asarray(x))


def log1p(x):
    return _map_data(x, np.log1p)


def sqrt(x):
    return _map_data(x, np.sqrt)


def cpm(x, target_sum: float = 1e4):
    """Counts scaled so every cell sums to target_sum ("CP10K" default)."""
    return scale_rows(x, target_sum / library_size(x))


def normalize_total(x, target_sum: float | None = None):
    """scanpy sc.pp.normalize_total semantics: target_sum=None scales to
    the MEDIAN library size (the shipped scMNC default upstream of the
    per-gene z-score; RESULTS.md sweep winner)."""
    depth = library_size(x)
    target = float(np.median(depth)) if target_sum is None else target_sum
    return scale_rows(x, target / depth)


def normalize_log_cpm(x, target_sum: float = 1e4):
    """log1p(CPM): the most common single-cell default."""
    return log1p(cpm(x, target_sum))


def normalize_deseq(x):
    """Median-of-ratios (DESeq/scran-flavor) size factors, then log1p.
    Genes with any zero are excluded from the geometric mean, as DESeq
    does; raises when no gene is expressed in every cell."""
    x = densify(x, np.float64)
    pos = (x > 0).all(axis=0)
    if not pos.any():
        raise ValueError(
            'DESeq median-of-ratios undefined: no all-nonzero gene; use a '
            'CPM/UQ/TMM transform for this matrix')
    ref = np.exp(np.log(x[:, pos]).mean(axis=0))  # per-gene geometric mean
    sf = np.median(x[:, pos] / ref, axis=1, keepdims=True)
    sf = np.maximum(sf, 1e-9)
    return np.log1p(x / sf)


def normalize_tmm(x, trim_m: float = 0.3, trim_a: float = 0.05,
                  target_sum: float = 1e4):
    """edgeR TMM (Robinson & Oshlack 2010): per-cell effective library
    sizes from the doubly-trimmed, precision-weighted mean of M-values
    against the reference cell (the one whose upper quartile is closest
    to the mean upper quartile), then log-CPM(target_sum) by effective
    depth."""
    x = densify(x, np.float64)
    depth = np.maximum(x.sum(1, keepdims=True), 1.0)
    p = x / depth
    uq = np.quantile(p, 0.75, axis=1)
    ref_i = int(np.argmin(np.abs(uq - uq.mean())))
    ref = p[ref_i]
    factors = np.ones(x.shape[0])
    for i in range(x.shape[0]):
        both = (p[i] > 0) & (ref > 0)
        if both.sum() < 50:
            continue
        pi, pr = p[i][both], ref[both]
        m = np.log2(pi / pr)
        a = 0.5 * np.log2(pi * pr)
        # inverse asymptotic variance of M (edgeR's weights)
        w = ((1 - pi) / (pi * depth[i, 0])
             + (1 - pr) / (pr * depth[ref_i, 0]))
        mlo, mhi = np.quantile(m, [trim_m, 1 - trim_m])
        alo, ahi = np.quantile(a, [trim_a, 1 - trim_a])
        keep = (m >= mlo) & (m <= mhi) & (a >= alo) & (a <= ahi)
        if keep.sum() >= 10:
            factors[i] = 2 ** (np.sum(m[keep] / w[keep])
                               / np.sum(1.0 / w[keep]))
    factors /= np.exp(np.mean(np.log(factors)))  # geometric mean 1
    return np.log1p(x / (depth * factors[:, None]) * target_sum)


def normalize_upper_quartile(x):
    """Upper-quartile size factors (Bullard et al. 2010): 75th percentile
    of each cell's nonzero counts, geometric-mean-centered, then log1p."""
    x = densify(x, np.float64)
    uq = np.array([np.quantile(r[r > 0], 0.75) if (r > 0).any() else 1.0
                   for r in x])
    sf = uq / np.exp(np.mean(np.log(np.maximum(uq, 1e-9))))
    return np.log1p(x / sf[:, None])


def normalize_quantile(x):
    """Full quantile normalization across cells (each cell's counts mapped
    onto the mean sorted profile; limma/affy-style), then log1p."""
    x = densify(x, np.float64)
    order = np.argsort(x, axis=1)
    ranks = np.argsort(order, axis=1)
    mean_sorted = np.sort(x, axis=1).mean(axis=0)
    return np.log1p(mean_sorted[ranks])


def pearson_residuals(x, theta: float = 100.0):
    """Analytic Pearson residuals (SCTransform-flavor, Lause et al. 2021),
    clipped to +-sqrt(n)."""
    x = densify(x, np.float64)
    total = x.sum()
    mu = np.maximum(x.sum(1, keepdims=True), 1.0) \
        * x.sum(0, keepdims=True) / total
    r = (x - mu) / np.sqrt(mu + mu * mu / theta)
    n = x.shape[0]
    return np.clip(r, -np.sqrt(n), np.sqrt(n))


def zscore(x, axis: int = 0, eps: float = 0.0):
    """Per-feature (axis=0) standardization with NaN -> 0, as every
    reference notebook applies after its load (e.g. scGEM.ipynb cell 4:
    sklearn preprocessing.scale + nan fix). Densifies: centering destroys
    sparsity by construction."""
    x = densify(x, np.float64)
    mean = x.mean(axis=axis, keepdims=True)
    std = x.std(axis=axis, keepdims=True)
    if eps:
        std = std + eps
    else:
        std[std == 0] = 1.0
    out = (x - mean) / std
    out[np.isnan(out)] = 0.0
    return out
