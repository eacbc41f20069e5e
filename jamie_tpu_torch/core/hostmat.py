"""Host-matrix helpers: uniform handling of dense and scipy-sparse inputs.

A copy of `jamie_tpu/core/hostmat.py` (this package imports nothing of
`jamie_tpu`). Single-cell matrices arrive sparse (10x matrices are born
CSR); densifying a 100k x 40k matrix on the host costs 16 GB before the
pipeline starts. Every streaming device route (the bf16 residency build,
the feature-chunked Gram, the streamed PCA routes, landmark selection)
densifies only the row or column block it is about to use, so sparse
inputs flow through `fit_transform` with peak host memory O(block).

Conventions: row-streamed consumers want CSR (`ensure_row_major`; the
estimator normalizes inputs once), column-streamed consumers convert to
CSC themselves (`ensure_col_major`), so the O(nnz) transpose-copy happens
once, not per chunk.
"""

from __future__ import annotations

import numpy as np


def is_scipy_sparse(x) -> bool:
    """scipy.sparse matrix/array check without importing scipy."""
    return type(x).__module__.startswith('scipy.sparse')


def ensure_row_major(x):
    """CSR (cheap row slicing) for anything sparse; dense passes through."""
    if is_scipy_sparse(x) and x.format != 'csr':
        return x.tocsr()
    return x


def ensure_col_major(x):
    """CSC (cheap column slicing) for anything sparse; dense passes through.
    Column-streaming a CSR costs a full O(nnz) scan PER chunk: convert
    once before the chunk loop."""
    if is_scipy_sparse(x) and x.format != 'csc':
        return x.tocsc()
    return x


def densify(x, dtype=np.float32) -> np.ndarray:
    """Whole matrix as a C-contiguous dense ndarray of `dtype` (None keeps
    the stored dtype)."""
    if is_scipy_sparse(x):
        x = x.toarray()
    return np.ascontiguousarray(x, dtype=dtype)


def dense_rows(x, start: int, stop: int, dtype=np.float32) -> np.ndarray:
    """Rows [start:stop) as a C-contiguous dense block of `dtype`."""
    return densify(x[start:stop], dtype)


def dense_cols(x, start: int, stop: int, dtype=np.float32) -> np.ndarray:
    """Columns [start:stop) as a C-contiguous dense block of `dtype` (pass
    CSC for sparse inputs; see ensure_col_major)."""
    return densify(x[:, start:stop], dtype)


def as_f32_ndarray(x):
    """float32 host array that PRESERVES ndarray identity when x already is
    one (np.memmap included). np.asarray(memmap) returns a fresh base-class
    view per call, whose id() changes, so the id-keyed residency cache
    would upload the same matrix once per phase."""
    if isinstance(x, np.ndarray) and x.dtype == np.float32:
        return x
    return np.asarray(x, np.float32)
