"""Host-matrix helpers.

The part of `jamie_tpu/core/hostmat.py` the dense main path needs, copied
(this package imports nothing of `jamie_tpu`): `is_scipy_sparse` to refuse
sparse inputs, `as_f32_ndarray` to keep ndarray identity. The streaming
helpers join when the sparse and atlas routes are ported (ROADMAP item 11).
"""

from __future__ import annotations

import numpy as np


def is_scipy_sparse(x) -> bool:
    """scipy.sparse matrix/array check without importing scipy."""
    return type(x).__module__.startswith('scipy.sparse')


def as_f32_ndarray(x):
    """float32 host array that PRESERVES ndarray identity when x already is
    one (np.memmap included — it keeps .filename, the on-disk encode-cache
    key). np.asarray(memmap) returns a fresh base-class view per call:
    .filename is lost AND id() is unstable, so the id-keyed residency cache
    re-uploads the same matrix once per phase (caught in round 4: the warm
    scGLUE leg shipped 1,651.8 MB — exactly two full resident builds)."""
    if isinstance(x, np.ndarray) and x.dtype == np.float32:
        return x
    return np.asarray(x, np.float32)
