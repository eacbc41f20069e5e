"""Low-rank correspondence layouts: F = U V^T, never materialized.

Reference parity: `jamie_tpu/ops/lowrank.py`. The landmark solver
(`solvers/landmark.py`) returns F as a rank-L factorization instead of a
dense (N0, N1) matrix, and every consumer needs only:

- batch blocks F[idx0][:, idx1] (the trainer's per-step gather): two row
  gathers and one (B, L) x (L, B) matmul;
- column sums and column normalization (`final_corr`): a row scaling of V;
- a per-row top-k (`final_corr` past its dense budget): computed in row
  blocks on the device, never the whole product.

`LowRankF` holds the dense factors U = A_x F_L (N0, L) and V = A_y (N1, L);
`SparseLandmarkF` holds only the k-sparse interpolation factors and the
(L0, L1) landmark correspondence and re-mixes rows on the fly. Both keep
their tensors on one device: the card unless the caller passes another
`device`, or the device of tensors passed in when none is given. Row
indices may be numpy arrays or tensors. torch.topk may order tied values
differently from `lax.top_k`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import resolve_device


def _tensor(x, dtype, device) -> torch.Tensor:
    """x as a `dtype` tensor: on `device` if given, else where a tensor x
    already lies, else on the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else device,
                    dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def _index(idx, device) -> torch.Tensor:
    return _tensor(idx, torch.long, device)


def _block_topk(u_blk, v, k: int):
    return torch.topk(u_blk @ v.T, k, dim=1)


def _scatter_rows(idx, w, n_cols: int):
    """Dense (B, n_cols) from per-row k-sparse (idx, w). Indices are
    distinct per row, so adding equals setting."""
    a = torch.zeros((idx.shape[0], n_cols), dtype=torch.float32,
                    device=w.device)
    return a.scatter_add_(1, idx, w)


def _mix_rows(idx, w, f_l):
    """(A F_L) for k-sparse rows: each output row is a w-weighted mixture of
    k rows of f_l, a (B, k, L1) gather and contraction with no (B, L0)
    intermediate."""
    fb = f_l[idx.reshape(-1)].reshape(*idx.shape, f_l.shape[1])
    return torch.einsum('bk,bkl->bl', w, fb)


def _topk_merge(best_v, best_c, scores, col0: int, k: int):
    """Fold one (B, C) score block into a running per-row top-k."""
    if scores.shape[1] < k:
        scores = torch.nn.functional.pad(scores, (0, k - scores.shape[1]),
                                         value=-float('inf'))
    v2, c2 = torch.topk(scores, k, dim=1)
    cand_v = torch.cat([best_v, v2], dim=1)
    cand_c = torch.cat([best_c, c2 + col0], dim=1)
    v3, sel = torch.topk(cand_v, k, dim=1)
    return v3, torch.gather(cand_c, 1, sel)


def _sparse_rows(cols_out, vals_out, shape):
    from .sparse import SparseRows
    keep = vals_out > 0
    return SparseRows(np.where(keep, cols_out, -1),
                      np.where(keep, vals_out, 0.0), shape)


class LowRankF:
    """F = u @ v.T with logical shape (u.shape[0], v.shape[0])."""

    def __init__(self, u, v, device=None):
        self.u = _tensor(u, torch.float32, device)
        self.v = _tensor(v, torch.float32, self.u.device)
        assert self.u.dim() == 2 and self.v.dim() == 2
        assert self.u.shape[1] == self.v.shape[1], (
            f'rank mismatch: {tuple(self.u.shape)} vs {tuple(self.v.shape)}')
        self.shape = (int(self.u.shape[0]), int(self.v.shape[0]))
        self.rank = int(self.u.shape[1])

    @property
    def device(self) -> torch.device:
        return self.u.device

    def to(self, device) -> 'LowRankF':
        return LowRankF(self.u, self.v, device=device)

    # ------------------------------------------------------------- consumers
    def gather_batch(self, idx0, idx1) -> torch.Tensor:
        """F[idx0][:, idx1] without materializing F."""
        dev = self.device
        return self.u[_index(idx0, dev)] @ self.v[_index(idx1, dev)].T

    def col_sums(self) -> torch.Tensor:
        """F^T 1 as a length-N1 vector: (sum_i u_i) . v_j."""
        return self.v @ self.u.sum(0)

    def col_normalized(self) -> 'LowRankF':
        """Columns scaled to sum 1 (zero columns left at zero), still
        rank-L: col-normalization of u v^T is a row scaling of v."""
        s = self.col_sums()
        scale = torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-12),
                            torch.zeros_like(s))
        return LowRankF(self.u, self.v * scale[:, None])

    def to_dense(self, max_entries: int = 200_000_000) -> np.ndarray:
        n = self.shape[0] * self.shape[1]
        if n > max_entries:
            raise ValueError(
                f'refusing to densify {self.shape} low-rank F ({n} entries);'
                ' use top_k() or gather_batch()')
        return (self.u @ self.v.T).cpu().numpy()

    def top_k(self, k: int, block: int = 4096):
        """Largest-k entries per row as SparseRows, in row blocks on the
        device: the dense (N0, N1) product never exists whole."""
        n0, n1 = self.shape
        k = min(int(k), n1)
        cols_out = np.empty((n0, k), np.int32)
        vals_out = np.empty((n0, k), np.float32)
        for s in range(0, n0, block):
            vals, cols = _block_topk(self.u[s:s + block], self.v, k)
            vals_out[s:s + block] = vals.cpu().numpy()
            cols_out[s:s + block] = cols.cpu().numpy()
        return _sparse_rows(cols_out, vals_out, self.shape)

    @property
    def T(self) -> 'LowRankF':
        """The transpose stays factorized."""
        return LowRankF(self.v, self.u)

    def __repr__(self):
        return f'LowRankF(shape={self.shape}, rank={self.rank})'


class SparseLandmarkF(LowRankF):
    """F = (A_x F_L) A_y^T with k-sparse interpolation factors.

    Stores the (N, k) landmark indices and weights of each side plus the
    (L0, L1) landmark correspondence: O(N k + L^2) memory instead of the
    dense factors' O(N L). Same math as `LowRankF(A_x F_L, A_y)`: every
    method agrees with it up to float32 summation order.
    """

    def __init__(self, ix, wx, iy, wy, f_l, device=None):
        self.f_l = _tensor(f_l, torch.float32, device)    # (L0, L1)
        dev = self.f_l.device
        self.ix = _tensor(ix, torch.long, dev)            # (N0, k)
        self.wx = _tensor(wx, torch.float32, dev)         # (N0, k)
        self.iy = _tensor(iy, torch.long, dev)            # (N1, k)
        self.wy = _tensor(wy, torch.float32, dev)         # (N1, k)
        assert self.ix.shape == self.wx.shape and self.ix.dim() == 2
        assert self.iy.shape == self.wy.shape and self.iy.dim() == 2
        assert self.f_l.dim() == 2
        self.shape = (int(self.ix.shape[0]), int(self.iy.shape[0]))
        self.rank = int(self.f_l.shape[1])

    @property
    def device(self) -> torch.device:
        return self.f_l.device

    def to(self, device) -> 'SparseLandmarkF':
        return SparseLandmarkF(self.ix, self.wx, self.iy, self.wy, self.f_l,
                               device=device)

    # Dense factors on demand (small-N paths; to_dense guards the size, the
    # trainer never builds them for this layout)
    @property
    def u(self) -> torch.Tensor:
        return _mix_rows(self.ix, self.wx, self.f_l)

    @property
    def v(self) -> torch.Tensor:
        return _scatter_rows(self.iy, self.wy, self.rank)

    def gather_batch(self, idx0, idx1) -> torch.Tensor:
        dev = self.device
        idx0, idx1 = _index(idx0, dev), _index(idx1, dev)
        u_b = _mix_rows(self.ix[idx0], self.wx[idx0], self.f_l)
        v_b = _scatter_rows(self.iy[idx1], self.wy[idx1], self.rank)
        return u_b @ v_b.T

    def col_sums(self) -> torch.Tensor:
        # 1^T A_x lands in L0 bins, flows through f_l, then mixes out
        # through each column cell's k weights
        cx = torch.zeros(self.f_l.shape[0], dtype=torch.float32,
                         device=self.device)
        cx.index_add_(0, self.ix.reshape(-1), self.wx.reshape(-1))
        t = cx @ self.f_l                                 # (L1,)
        return (t[self.iy] * self.wy).sum(1)

    def col_normalized(self) -> 'SparseLandmarkF':
        s = self.col_sums()
        scale = torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-12),
                            torch.zeros_like(s))
        return SparseLandmarkF(self.ix, self.wx, self.iy,
                               self.wy * scale[:, None], self.f_l)

    def top_k(self, k: int, block: int = 4096, col_block: int = 65536):
        """Double-blocked: row blocks mix u on the fly, column blocks
        scatter v on the fly, and a running top-k merge keeps the live state
        at (block, k). Neither dense factor ever exists whole."""
        n0, n1 = self.shape
        k = min(int(k), n1)
        cols_out = np.empty((n0, k), np.int32)
        vals_out = np.empty((n0, k), np.float32)
        for s in range(0, n0, block):
            u_b = _mix_rows(self.ix[s:s + block], self.wx[s:s + block],
                            self.f_l)
            best_v = torch.full((u_b.shape[0], k), -float('inf'),
                                dtype=torch.float32, device=self.device)
            best_c = torch.zeros((u_b.shape[0], k), dtype=torch.long,
                                 device=self.device)
            for c in range(0, n1, col_block):
                v_b = _scatter_rows(self.iy[c:c + col_block],
                                    self.wy[c:c + col_block], self.rank)
                best_v, best_c = _topk_merge(best_v, best_c, u_b @ v_b.T,
                                             c, k)
            vals_out[s:s + block] = best_v.cpu().numpy()
            cols_out[s:s + block] = best_c.cpu().numpy()
        return _sparse_rows(cols_out, vals_out, self.shape)

    @property
    def T(self) -> 'SparseLandmarkF':
        return SparseLandmarkF(self.iy, self.wy, self.ix, self.wx,
                               self.f_l.T)

    def __repr__(self):
        return (f'SparseLandmarkF(shape={self.shape}, '
                f'k={self.ix.shape[1]}, landmarks={tuple(self.f_l.shape)})')


def is_lowrank(x) -> bool:
    """True for a LowRankF (SparseLandmarkF included), as jamie_tpu's."""
    return isinstance(x, LowRankF)


_SPARSE_FIELDS = ('ix', 'wx', 'iy', 'wy', 'f_l')


def from_fields(F, device=None) -> LowRankF:
    """The counterpart of a jamie_tpu `LowRankF` or `SparseLandmarkF` (or of
    any object with the same array fields), carried across by its arrays:
    `ix/wx/iy/wy/f_l` for the sparse layout, else `u/v`."""
    if all(hasattr(F, a) for a in _SPARSE_FIELDS):
        return SparseLandmarkF(*(np.array(getattr(F, a))
                                 for a in _SPARSE_FIELDS), device=device)
    return LowRankF(np.array(F.u), np.array(F.v), device=device)
