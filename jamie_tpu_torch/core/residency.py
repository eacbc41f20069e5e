"""Device residency for large host matrices.

Reference parity: `jamie_tpu/core/residency.py`. The wide-modality phases
(pairwise distances, PCA, the landmark weights) read the raw cells x
features matrix more than once. Past `BF16_LINK_ELEMS` dense elements its
values are rounded to bf16, and it is kept on the device once and shared
between the phases:

- `device_bf16`: the whole matrix as one dense bf16 tensor (9190 x 241757
  ATAC is 4.4 GB), built from row chunks (`build_resident_bf16`), cached
  per host array while it fits `DEFAULT_BUDGET_BYTES`;
- `device_csr`: a scipy CSR matrix as a `DeviceCSR`, a torch sparse CSR
  tensor whose products (`matmul`, `tmatmul`) run through `torch.sparse.mm`
  (cuSPARSE on the card) without a dense block, and whose `rows` decode
  dense f32 blocks on the device;
- `ChunkUploader`: dense f32 row or column blocks of a matrix that is not
  resident, for the streamed routes.

Rounding rule, shared by all three: a matrix of `n * f >=
BF16_LINK_ELEMS` dense elements has its values rounded to the nearest bf16
(ties to even, `Tensor.to(torch.bfloat16)`); below that they stay exact
float32. Products accumulate in float32. The caches are keyed by the host
array's identity, checked by a weakref and a content fingerprint (an
in-place mutation warns and rebuilds), and are released by
`clear_residency_cache` before training claims device memory.

`transfer_stats()` counts every host->device upload of this module
(jamie_tpu's four keys, and one more): `bytes` shipped, `bf16_equiv_bytes`
(2 bytes per dense element the upload yields on the device, jamie_tpu's
measure of one dense-bf16 shipment), `read_s` (host seconds reading or
densifying a source chunk), `encode_s` (host seconds of the bf16 cast) and
`copy_s` (host seconds in the uploads' `.to(device)`, a pageable copy that
returns once it is done). A memmapped chunk that is already C-contiguous
float32 is paged in by the cast, so its read counts in `encode_s`.
`reset_transfer_stats()` zeroes them. A whole-matrix build is a
`residency.build` span (`core/timing`) that carries its own share of them.

Not ported, on the card's evidence (H100 80GB HBM3 host, PERF.md): the
link formats (bit-packed, u8 and padded-CSR payloads, jamie_tpu's
:180-400), the on-disk encode cache (:400-550) and `_Backpressure`
(:257-291). The scGLUE ATAC (9190 x 241,757, two-valued columns) builds
its residency in 1.50 s: 0.82 s of host bf16 cast and 0.68 s of copy
(4.44 GB at 6.6 GB/s). Packed bits would ship 0.28 GB (0.04 s) but their
host encode (per-column min/max, two equality passes, packbits) takes
4.1 s there: slower. The encode cache would replay that payload for a
memmapped source in place of the cast and the copy, at most ~1.5 s of a
~1400 s fit. `_Backpressure` bounds asynchronous uploads; a pageable
`.to(device)` returns after its copy, so one chunk is in flight at a
time. Their numerics come to "exact for two-valued or small-integer
data, bf16 for continuous data", which the rounding rule reproduces:
such values are exact in bf16. Sparse blocks still travel as CSR and are
decoded on the device. `jamie_tpu`'s row-split ELL layout (:777-951) was
designed around the TPU's serialized scatter; here the layout is torch's
CSR and the product is a library SpMM, as the ELL einsum was XLA code
outside any Pallas kernel.

`route_counts` counts which route each call site took (distances, PCA,
FPS, landmark weights, PCA transform), for the checks of a run.
"""

from __future__ import annotations

import collections
import hashlib
import time
import warnings
import weakref
from typing import Optional

import numpy as np
import torch

from . import timing
from .dtypes import resolve_device
from .hostmat import dense_rows, is_scipy_sparse

# Whole-matrix residency budget, per matrix. The residencies of both
# modalities stay on the device through the dense solve (they are released
# after preprocessing), so two of them must fit beside the largest default
# dense fit. jamie_tpu's value, kept for the card's reason: the `fit` probe
# at 29,154^2 entries (f32 state, at estimator.DENSE_F32_STATE_ENTRIES)
# with two budget-sized resident inputs peaked at 80.92 GB for 6 GiB and
# 83.06 GB for 7 GiB, of the 85.0 GB of an H100 80GB HBM3 at 700.00 W;
# 7 GiB leaves less than the 1.9-11.4 GiB the allocator held unusable in
# the rungs that ran out (PERF.md). Read at call time.
DEFAULT_BUDGET_BYTES = 6 * 1024 ** 3

# At or above this many DENSE elements (n * f) a matrix's values are
# rounded to bf16; below it they stay exact float32. jamie_tpu's value,
# kept for the card's own reasons (H100 80GB HBM3, 700.00 W): at every
# size the `residency` probe ran, 72M to 4.8G elements, the bf16 routes
# took 1.15-4.7x less time than the exact f32 routes per modality
# (distances + PCA), and the `quality` probe put the rounding's cost
# inside the seed spread; below the pivot the exact route costs at most
# 0.21 s a modality (PERF.md). Read at call time.
BF16_LINK_ELEMS = 100_000_000

# route name -> calls since the last clear()
route_counts: collections.Counter = collections.Counter()

# Host->device transfer accounting (see the module docstring)
_transfer = {'bytes': 0, 'bf16_equiv_bytes': 0, 'read_s': 0.0,
             'encode_s': 0.0, 'copy_s': 0.0}


def transfer_stats() -> dict:
    return dict(_transfer)


def reset_transfer_stats() -> None:
    _transfer.update(bytes=0, bf16_equiv_bytes=0, read_s=0.0, encode_s=0.0,
                     copy_s=0.0)


def _ship(*arrays, device) -> list:
    """Host numpy arrays or CPU tensors on `device`, their bytes and the
    copies' host seconds counted."""
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        _transfer['bytes'] += t.numel() * t.element_size()
        t0 = time.perf_counter()
        out.append(t.to(device))
        _transfer['copy_s'] += time.perf_counter() - t0
    return out

_cache: dict = {}       # (id(arr), device) -> (weakref, bf16 tensor, fingerprint)
_csr_cache: dict = {}   # (id(X), device) -> (weakref, DeviceCSR, fingerprint)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bf16 (ties to even), as f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def host_bf16(arr: np.ndarray) -> torch.Tensor:
    """A host float32 array as a CPU bf16 tensor (round to nearest even).
    The read of a non-contiguous or memmapped source counts as `read_s`,
    the cast as `encode_s`."""
    t0 = time.perf_counter()
    x = np.ascontiguousarray(arr, np.float32)
    t1 = time.perf_counter()
    with warnings.catch_warnings():
        # a read-only (e.g. memmap-backed) array is only read here
        warnings.simplefilter('ignore', UserWarning)
        out = torch.from_numpy(x).to(torch.bfloat16)
    _transfer['read_s'] += t1 - t0
    _transfer['encode_s'] += time.perf_counter() - t1
    return out


def _sparse_csr(crow, col, vals, shape) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)   # "beta state"
        return torch.sparse_csr_tensor(crow, col, vals, size=shape,
                                       check_invariants=False)


def _index_dtype(nnz: int, *dims: int):
    """int32 CSR indices where they fit (half the bytes), else int64."""
    return np.int32 if max(nnz, *dims) < 2 ** 31 - 1 else np.int64


def _csr_block_to_device(chunk, device, rounded: bool) -> torch.Tensor:
    """A scipy-sparse block as a dense f32 block on `device`: shipped as CSR
    (indices + values, values bf16-rounded when `rounded`) and decoded
    there. Duplicate entries are summed first, as densify would."""
    if chunk.format != 'csr':
        chunk = chunk.tocsr()
    elif not chunk.has_canonical_format:
        chunk = chunk.copy()
        chunk.sum_duplicates()
    r, f = chunk.shape
    _transfer['bf16_equiv_bytes'] += 2 * r * f
    if chunk.nnz == 0:
        return torch.zeros((r, f), dtype=torch.float32, device=device)
    idt = _index_dtype(int(chunk.nnz), r, f)
    crow, col, vals = _ship(chunk.indptr.astype(idt),
                            chunk.indices.astype(idt),
                            np.asarray(chunk.data, np.float32), device=device)
    if rounded:
        vals = round_bf16(vals)
    return _sparse_csr(crow, col, vals, (r, f)).to_dense()


def csr_to_device(x, device) -> torch.Tensor:
    """A whole scipy-sparse matrix as a dense exact-f32 tensor on `device`,
    shipped as CSR and decoded there: the exact routes under the
    thresholds never densify a sparse matrix on the host."""
    return _csr_block_to_device(x, resolve_device(device), False)


def content_fingerprint(arr) -> str:
    """Cheap content-sample hash of a host matrix (dense or scipy CSR/CSC):
    shape/dtype/strides plus the raw bytes of ~16 sampled rows (or sampled
    indptr/data/index slices for sparse). Catches in-place mutation of an
    identity-cached array, which the id()-keyed caches cannot see. Reads a
    few KB, never the whole matrix."""
    h = hashlib.sha1()
    data = getattr(arr, 'data', None)
    indptr = getattr(arr, 'indptr', None)
    if indptr is not None and not isinstance(arr, np.ndarray):
        h.update(f'{arr.shape}|{arr.dtype}|{arr.nnz}'.encode())
        h.update(np.ascontiguousarray(
            indptr[::max(1, len(indptr) // 64)]).tobytes())
        for v in (data, arr.indices):
            v = np.asarray(v)
            h.update(np.ascontiguousarray(v[:256]).tobytes())
            h.update(np.ascontiguousarray(v[-256:]).tobytes())
            h.update(np.ascontiguousarray(
                v[:: max(1, v.shape[0] // 16)][:32]).tobytes())
    else:
        a = arr
        h.update(f'{a.shape}|{a.dtype}|{getattr(a, "strides", None)}|'
                 f'{getattr(a, "offset", 0)}'.encode())
        n = a.shape[0]
        step = max(1, n // 16)
        width = min(a.shape[1], 512) if a.ndim == 2 else None
        for i in list(range(0, n, step))[:17] + ([n - 1] if n else []):
            row = a[i, :width] if width is not None else a[i]
            h.update(np.ascontiguousarray(row).tobytes())
    return h.hexdigest()


class DeviceCSR:
    """A scipy CSR matrix resident on `device` as a torch sparse CSR tensor.

    Uploaded once: int32 indices where they fit, float32 values that are
    exact below `BF16_LINK_ELEMS` dense elements and bf16-rounded at or
    above it. `matmul(M, s, e)` computes X[s:e] @ M and `tmatmul(Q)` X^T @ Q
    with `torch.sparse.mm` (M and Q cast to the values' precision, f32
    accumulation), so no dense block exists; `rows(s, e)` decodes a dense
    f32 block; `row_sq_sums` is the |x|^2 of the cell->landmark Gram. A
    non-canonical CSR (unsorted or duplicate entries) is copied and its
    duplicates summed, as the dense path sums them: the caller's matrix is
    never mutated."""

    def __init__(self, X, device=None):
        if not X.has_canonical_format:
            X = X.copy()
            X.sum_duplicates()
        n, f = (int(d) for d in X.shape)
        self.shape = (n, f)
        self.device = resolve_device(device)
        self.indptr_np = np.asarray(X.indptr, np.int64)
        self.nnz = int(self.indptr_np[-1])
        self.bf16 = n * f >= BF16_LINK_ELEMS
        idt = _index_dtype(self.nnz, n, f)
        self.crow, self.col, vals = _ship(
            X.indptr.astype(idt), X.indices.astype(idt),
            np.asarray(X.data, np.float32), device=self.device)
        self.vals = round_bf16(vals) if self.bf16 else vals
        # one dense-bf16 shipment of this matrix, counted once per build:
        # the decodes from it (build_resident_bf16, ChunkUploader.rows)
        # ship nothing and count nothing more, where jamie_tpu counts
        # each of them again
        _transfer['bf16_equiv_bytes'] += 2 * n * f
        self._csc = None          # lazy transposed twin (CSR of X^T)
        self._row_sq = None       # lazy (n,) f32

    def _csr(self, s: int, e: int) -> torch.Tensor:
        """Rows [s, e) as a sparse CSR tensor over views of the arrays."""
        a, b = int(self.indptr_np[s]), int(self.indptr_np[e])
        crow = self.crow[s:e + 1] - self.crow[s]
        return _sparse_csr(crow, self.col[a:b], self.vals[a:b],
                           (e - s, self.shape[1]))

    def _operand(self, M) -> torch.Tensor:
        """M on the device as contiguous f32, bf16-rounded when the values
        are (jamie_tpu casts M to the values' dtype)."""
        M = torch.as_tensor(M).to(device=self.device, dtype=torch.float32)
        return (round_bf16(M) if self.bf16 else M).contiguous()

    def rows(self, s: int, e: int) -> torch.Tensor:
        """Rows [s, e) as a dense f32 device block."""
        e = min(e, self.shape[0])
        return self._csr(s, e).to_dense()

    def matmul(self, M, s: int = 0, e: Optional[int] = None) -> torch.Tensor:
        """X[s:e] @ M, (e - s, k) f32, without a dense block."""
        e = self.shape[0] if e is None else min(e, self.shape[0])
        M = self._operand(M)
        if self.indptr_np[e] == self.indptr_np[s]:
            return torch.zeros((e - s, M.shape[1]), dtype=torch.float32,
                               device=self.device)
        return torch.sparse.mm(self._csr(s, e), M)

    def tmatmul(self, Q) -> torch.Tensor:
        """X^T @ Q, (f, k) f32, through the transposed twin: the CSC form of
        X read as the CSR of X^T, converted once on the device."""
        Q = self._operand(Q)
        if self.nnz == 0:
            return torch.zeros((self.shape[1], Q.shape[1]),
                               dtype=torch.float32, device=self.device)
        if self._csc is None:
            csc = self._csr(0, self.shape[0]).to_sparse_csc()
            self._csc = _sparse_csr(csc.ccol_indices(), csc.row_indices(),
                                    csc.values(), self.shape[::-1])
        return torch.sparse.mm(self._csc, Q)

    def release_csc(self) -> None:
        """Drop the transposed twin (it serves only the PCA projection
        passes); a later tmatmul rebuilds it."""
        self._csc = None

    def row_sq_sums(self) -> torch.Tensor:
        """Per-row sum of squared values (bf16-rounded at scale), (n,) f32,
        cached."""
        if self._row_sq is None:
            n, f = self.shape
            sq = _sparse_csr(self.crow, self.col, self.vals * self.vals,
                             (n, f))
            ones = torch.ones((f, 1), dtype=torch.float32, device=self.device)
            self._row_sq = (torch.sparse.mm(sq, ones)[:, 0] if self.nnz
                            else torch.zeros(n, device=self.device))
        return self._row_sq


def _cached(cache: dict, key, arr, what: str):
    """The cached device copy of `arr`, or None on a miss; warns and drops
    the entry when the host array was mutated in place."""
    hit = cache.get(key)
    if hit is None or hit[0]() is not arr:
        return None
    if content_fingerprint(arr) == hit[2]:
        return hit[1]
    warnings.warn(f'{what}: cached host matrix was mutated in place; '
                  'rebuilding the device copy (the residency contract is '
                  'read-only inputs)', stacklevel=3)
    del cache[key]
    return None


def _store(cache: dict, key, arr, dev) -> None:
    # the callback drops the device copy the moment the host array dies
    ref = weakref.ref(arr, lambda _r, _key=key: cache.pop(_key, None))
    cache[key] = (ref, dev, content_fingerprint(arr))


def device_csr(X, budget_bytes: Optional[int] = None, device=None):
    """X (scipy CSR) as a shared DeviceCSR on `device`, or None when X is
    not CSR or over the budget. The budget test is jamie_tpu's estimate of
    its own layout (uint16 or int32 columns, bf16 values, int32 indptr), so
    both packages take the same route; this layout takes 8 bytes a
    nonzero."""
    if not (is_scipy_sparse(X) and X.format == 'csr'):
        return None
    device = resolve_device(device)
    key = (id(X), str(device))
    hit = _cached(_csr_cache, key, X, 'device_csr')
    if hit is not None:
        return hit
    budget = DEFAULT_BUDGET_BYTES if budget_bytes is None else budget_bytes
    col_b = 2 if X.shape[1] < 65535 else 4
    if (col_b + 2) * int(X.nnz) + 4 * (X.shape[0] + 1) > budget:
        return None
    dev = DeviceCSR(X, device)
    _store(_csr_cache, key, X, dev)
    return dev


def build_resident_bf16(arr, device=None,
                        chunk_bytes: int = 256 << 20) -> torch.Tensor:
    """A host matrix (dense or scipy CSR) as one dense bf16 tensor on
    `device`, filled in row chunks: no whole-matrix f32 copy and no
    concatenate transient. A CSR source is decoded on the device through
    its DeviceCSR (shared with the other passes) or, past the CSR budget,
    chunk by chunk as CSR; a dense source is cast to bf16 on the host and
    shipped at 2 bytes an element. Values are round-to-nearest-even bf16
    of the float32 source either way. A `residency.build` span, whose
    counters are the build's share of `transfer_stats()`."""
    device = resolve_device(device)
    n, f = (int(d) for d in arr.shape)
    rows = max(int(chunk_bytes / max(f * 2, 1)), 64)
    before = dict(_transfer)
    with timing.span('residency.build') as sp:
        resident = torch.empty((n, f), dtype=torch.bfloat16, device=device)
        sparse_in = is_scipy_sparse(arr) and arr.format == 'csr'
        dcsr = device_csr(arr, device=device) if sparse_in else None
        for s in range(0, n, rows):
            e = min(s + rows, n)
            if dcsr is not None:   # counted once, by the DeviceCSR
                resident[s:e] = dcsr.rows(s, e)
                continue
            t0 = time.perf_counter()
            chunk = arr[s:e] if sparse_in else dense_rows(arr, s, e)
            _transfer['read_s'] += time.perf_counter() - t0
            if sparse_in:   # counts its own dense equivalent
                resident[s:e] = _csr_block_to_device(chunk, device, False)
            else:
                _transfer['bf16_equiv_bytes'] += 2 * (e - s) * f
                resident[s:e] = _ship(host_bf16(chunk), device=device)[0]
        sp.set(**{k: v - before[k] for k, v in _transfer.items()})
    return resident


def device_bf16(arr, budget_bytes: Optional[int] = None, device=None):
    """The whole matrix as a dense bf16 tensor on `device`, or None when it
    would not fit the budget. Cached per host array, so the distance and
    PCA phases share one build."""
    if budget_bytes is None:
        budget_bytes = DEFAULT_BUDGET_BYTES
    if not (isinstance(arr, np.ndarray) or is_scipy_sparse(arr)):
        return None
    # the resident copy is DENSE bf16 either way: count dense elements
    if int(arr.shape[0]) * int(arr.shape[1]) * 2 > budget_bytes:
        return None
    device = resolve_device(device)
    key = (id(arr), str(device))
    hit = _cached(_cache, key, arr, 'device_bf16')
    if hit is not None:
        return hit
    dev = build_resident_bf16(arr, device)
    _store(_cache, key, arr, dev)
    return dev


class ChunkUploader:
    """Dense f32 row or column blocks of a host matrix on `device`, for the
    streamed routes (row/column-streamed PCA, feature-chunked Gram, the
    JL sketch and landmark weights of a large dense source).

    Values are exact when n * f < BF16_LINK_ELEMS and bf16-rounded at or
    above it (a dense block then travels as bf16). A CSR source that fits
    the budget becomes a shared DeviceCSR once and `rows` decode from it;
    other sparse blocks travel as CSR and are decoded on the device.

    `limit_bytes` is accepted for jamie_tpu's signature and ignored: it
    caps jamie_tpu's pinned-memory backpressure, and every block here is
    consumed before the next one ships."""

    def __init__(self, X, device=None, limit_bytes: int = 1 << 30):
        self.X = X
        self.device = resolve_device(device)
        self.sparse = is_scipy_sparse(X)
        self.exact = int(X.shape[0]) * int(X.shape[1]) < BF16_LINK_ELEMS
        self.dcsr = (device_csr(X, device=self.device)
                     if self.sparse and X.format == 'csr' else None)

    def _block(self, blk) -> torch.Tensor:
        if self.sparse:
            return _csr_block_to_device(blk, self.device, not self.exact)
        _transfer['bf16_equiv_bytes'] += 2 * blk.shape[0] * blk.shape[1]
        if self.exact:
            t0 = time.perf_counter()
            x = np.ascontiguousarray(blk, np.float32)
            _transfer['read_s'] += time.perf_counter() - t0
            return _ship(x, device=self.device)[0]
        return _ship(host_bf16(blk), device=self.device)[0].to(torch.float32)

    def rows(self, s: int, e: int) -> torch.Tensor:
        """Rows [s, e) as a dense f32 device block."""
        e = min(e, int(self.X.shape[0]))
        if self.dcsr is not None:   # counted once, by the DeviceCSR
            return self.dcsr.rows(s, e)
        return self._block(self.X[s:e])

    def cols(self, s: int, e: int) -> torch.Tensor:
        """Columns [s, e) as a dense f32 device block (pass CSC for sparse
        sources: a CSR column slice scans every nonzero)."""
        blk = self.X[:, s:min(e, int(self.X.shape[1]))]
        return self._block(blk)


def clear_residency_cache() -> None:
    """Drop every resident copy (before the training phase claims device
    memory)."""
    _cache.clear()
    _csr_cache.clear()
