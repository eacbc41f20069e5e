"""Row-sparse (padded ELL) matrices for priors and correspondences.

Reference parity: `jamie_tpu/ops/sparse.py`. A `SparseRows` stores up to R
(column, value) slots per row, padded with column -1, on the host in numpy,
so an (N0, N1) prior or top-k correspondence costs O(N R) instead of
O(N0 N1). The trainer uploads its `cols`/`vals` once and gathers batch
blocks on the device with `sparse_gather_batch`: two row gathers plus a
(B, B, R) equality join, exact under duplicate indices (hybrid sampling
draws with replacement).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class SparseRows:
    """Padded per-row sparse matrix: cols (N, R) int32 with -1 padding,
    vals (N, R) float32, logical shape (N, M)."""

    def __init__(self, cols: np.ndarray, vals: np.ndarray,
                 shape: Tuple[int, int]):
        cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals, np.float32)
        assert cols.ndim == 2 and cols.shape == vals.shape
        self.cols = cols
        self.vals = np.where(cols >= 0, vals, 0.0).astype(np.float32)
        self.shape = (int(shape[0]), int(shape[1]))

    # --------------------------------------------------------- constructors
    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> 'SparseRows':
        rows = np.asarray(rows, np.int64).ravel()
        cols = np.asarray(cols, np.int64).ravel()
        vals = np.asarray(vals, np.float32).ravel()
        assert rows.shape == cols.shape == vals.shape
        n = int(shape[0])
        counts = np.bincount(rows, minlength=n)
        r = max(int(counts.max()) if len(rows) else 0, 1)
        ell_cols = np.full((n, r), -1, np.int32)
        ell_vals = np.zeros((n, r), np.float32)
        order = np.argsort(rows, kind='stable')
        r_sorted = rows[order]
        # slot index = position within the row group (vectorized cumcount)
        group_start = np.searchsorted(r_sorted, np.arange(n))
        slots = np.arange(len(r_sorted)) - group_start[r_sorted]
        ell_cols[r_sorted, slots] = cols[order]
        ell_vals[r_sorted, slots] = vals[order]
        return cls(ell_cols, ell_vals, shape)

    @classmethod
    def from_scipy(cls, mat) -> 'SparseRows':
        coo = mat.tocoo()
        return cls.from_coo(coo.row, coo.col, coo.data, coo.shape)

    @classmethod
    def from_dense(cls, dense, threshold: float = 0.0) -> 'SparseRows':
        dense = _host(dense)
        rows, cols = np.nonzero(np.abs(dense) > threshold)
        return cls.from_coo(rows, cols, dense[rows, cols], dense.shape)

    @classmethod
    def top_k(cls, dense, k: int) -> 'SparseRows':
        """Keep the k largest-magnitude entries of each row (exact zeros
        dropped). `dense` may be a host array or a tensor on any device."""
        dense = np.asarray(_host(dense), np.float32)
        n, m = dense.shape
        k = min(int(k), m)
        mag = np.abs(dense)
        idx = np.argpartition(-mag, k - 1, axis=1)[:, :k]
        vals = np.take_along_axis(dense, idx, axis=1)
        keep = np.take_along_axis(mag, idx, axis=1) > 0
        cols = np.where(keep, idx, -1).astype(np.int32)
        return cls(cols, np.where(keep, vals, 0.0), dense.shape)

    # ------------------------------------------------------------ conversions
    def to_dense(self) -> np.ndarray:
        """Dense (N, M) float32 matrix; slots that share a coordinate (COO
        duplicates, `final_corr`'s concatenated P and F slots) are summed,
        as in `col_sums` and `sparse_gather_batch`."""
        out = np.zeros(self.shape, np.float32)
        rows = np.repeat(np.arange(self.shape[0]), self.cols.shape[1])
        cols = self.cols.ravel()
        keep = cols >= 0
        np.add.at(out, (rows[keep], cols[keep]), self.vals.ravel()[keep])
        return out

    def pairs(self) -> np.ndarray:
        """(nnz, 2) row/col table of nonzero entries (the hybrid sampler's
        matched-pair list)."""
        rows = np.repeat(np.arange(self.shape[0]), self.cols.shape[1])
        keep = (self.cols.ravel() >= 0) & (self.vals.ravel() != 0)
        return np.stack([rows[keep], self.cols.ravel()[keep]],
                        axis=1).astype(np.int32)

    def transpose(self) -> 'SparseRows':
        """Re-bucket the slots by column through the coordinate list."""
        p = self.pairs()
        vals = self.vals.ravel()[
            (self.cols.ravel() >= 0) & (self.vals.ravel() != 0)]
        return SparseRows.from_coo(p[:, 1], p[:, 0], vals,
                                   (self.shape[1], self.shape[0]))

    @property
    def T(self) -> 'SparseRows':
        return self.transpose()

    # ------------------------------------------------------------ reductions
    @property
    def nnz(self) -> int:
        return int(((self.cols >= 0) & (self.vals != 0)).sum())

    def row_sums(self) -> np.ndarray:
        return self.vals.sum(axis=1)

    def col_sums(self) -> np.ndarray:
        out = np.zeros(self.shape[1], np.float32)
        keep = self.cols.ravel() >= 0
        np.add.at(out, self.cols.ravel()[keep], self.vals.ravel()[keep])
        return out

    def col_normalized(self) -> 'SparseRows':
        """Every entry divided by its column sum (zero-guarded): the sparse
        form of `losses.col_normalize` for `final_corr`."""
        sums = self.col_sums()
        denom = np.where(sums == 0, 1.0, sums)
        safe_cols = np.maximum(self.cols, 0)
        return SparseRows(self.cols, self.vals / denom[safe_cols], self.shape)

    def is_diagonal(self) -> bool:
        keep = (self.cols >= 0) & (self.vals != 0)
        rows = np.broadcast_to(
            np.arange(self.shape[0])[:, None], self.cols.shape)
        return bool((self.cols[keep] == rows[keep]).all())


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def is_sparse_input(P) -> bool:
    """True for inputs the trainer routes through SparseRows: a SparseRows,
    a scipy.sparse matrix, or a (rows, cols, vals, shape) / (rows, cols,
    vals) coordinate tuple."""
    if isinstance(P, SparseRows):
        return True
    if hasattr(P, 'tocoo') and hasattr(P, 'shape'):
        return True
    return (isinstance(P, tuple) and len(P) in (3, 4)
            and all(np.ndim(x) == 1 for x in P[:3]))


def as_sparse_rows(P, shape=None) -> SparseRows:
    if isinstance(P, SparseRows):
        return P
    if hasattr(P, 'tocoo'):
        return SparseRows.from_scipy(P)
    if isinstance(P, tuple):
        rows, cols, vals = P[:3]
        shp = P[3] if len(P) == 4 else shape
        assert shp is not None, 'coordinate-tuple P needs an explicit shape'
        return SparseRows.from_coo(rows, cols, vals, shp)
    raise TypeError(f'cannot interpret {type(P)!r} as a sparse matrix')


def sparse_gather_batch(cols: torch.Tensor, vals: torch.Tensor,
                        idx0: torch.Tensor, idx1: torch.Tensor
                        ) -> torch.Tensor:
    """Dense (B0, B1) block M[idx0[a], idx1[b]] of a SparseRows matrix held
    as device tensors (cols int, vals float32).

    Exact under duplicate indices: each output cell joins the a-th gathered
    row's slots against idx1[b]. The join is (B0, B1, R), so R must stay
    small (a top-k F or a partial prior)."""
    c = cols[idx0]                                      # (B0, R)
    v = vals[idx0]                                      # (B0, R)
    match = (c[:, None, :] == idx1[None, :, None]) & (c[:, None, :] >= 0)
    return torch.einsum('abr,ar->ab', match.to(v.dtype), v)
