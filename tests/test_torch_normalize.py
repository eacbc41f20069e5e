"""jamie_tpu_torch.normalize against jamie_tpu.normalize: every case of
tests/test_normalize.py through both packages on the same counts, the
outputs compared exactly (same dtype, same values, sparse stays sparse)."""

import os
import sys

import numpy as np
import pytest
from scipy import sparse

from jamie_tpu import normalize as jnz
from jamie_tpu_torch import normalize as nz


@pytest.fixture
def counts():
    rng = np.random.RandomState(0)
    x = rng.poisson(2.0, size=(30, 50)).astype(np.float64)
    x[rng.rand(30, 50) < 0.4] = 0
    x[0] = 0                      # an empty cell must not divide by zero
    return x


def _same(ours, ref):
    assert sparse.issparse(ours) == sparse.issparse(ref)
    if sparse.issparse(ours):
        assert ours.format == ref.format
        ours, ref = ours.toarray(), ref.toarray()
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _both(name, *args, **kw):
    ours = getattr(nz, name)(*args, **kw)
    _same(ours, getattr(jnz, name)(*args, **kw))
    return ours


def test_all_names_ported():
    assert nz.__all__ == jnz.__all__


def test_cpm_rows_sum_to_target(counts):
    out = _both('cpm', counts, 1e4)
    sums = out.sum(axis=1)
    np.testing.assert_allclose(sums[1:], 1e4, rtol=1e-9)
    assert sums[0] == 0.0         # empty cell stays empty
    _same(nz.library_size(counts), jnz.library_size(counts))


def test_scale_rows_preserves_f32(counts):
    x32 = counts.astype(np.float32)
    assert _both('cpm', x32).dtype == np.float32
    assert _both('cpm', sparse.csr_matrix(x32)).dtype == np.float32
    assert _both('cpm', counts).dtype == np.float64
    assert _both('cpm', counts.astype(np.int64)).dtype == np.float64
    _both('scale_rows', sparse.csc_matrix(x32), np.arange(30.0))


def test_normalize_total_median(counts):
    out = _both('normalize_total', counts)
    med = np.median(np.maximum(counts.sum(1), 1.0))
    np.testing.assert_allclose(out[1:].sum(axis=1), np.full(29, med),
                               rtol=1e-9)


@pytest.mark.parametrize('name', ['cpm', 'normalize_total', 'log1p', 'sqrt',
                                  'normalize_log_cpm'])
def test_sparse_preserving_family(counts, name):
    csr = sparse.csr_matrix(counts)
    out = _both(name, csr)
    assert sparse.issparse(out), name
    assert out.nnz <= csr.nnz + 1
    np.testing.assert_allclose(out.toarray(), np.asarray(_both(name, counts)),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('name', ['normalize_tmm', 'normalize_upper_quartile',
                                  'normalize_quantile', 'pearson_residuals'])
def test_dense_factor_methods_run(counts, name):
    out = _both(name, sparse.csr_matrix(counts))
    assert out.shape == counts.shape
    assert np.isfinite(out).all()


def test_deseq_requires_all_nonzero_gene(counts):
    for pkg in (nz, jnz):
        with pytest.raises(ValueError):
            pkg.normalize_deseq(counts)
    out = _both('normalize_deseq', counts + 1.0)
    assert np.isfinite(out).all()


def test_zscore_matches_notebook_semantics(counts):
    out = _both('zscore', counts)
    keep = counts.std(axis=0) > 0
    np.testing.assert_allclose(out[:, keep].mean(axis=0), 0, atol=1e-12)
    np.testing.assert_allclose(out[:, keep].std(axis=0), 1, rtol=1e-9)
    assert (out[:, ~keep] == 0).all()
    _both('zscore', counts, axis=1, eps=1e-3)


def test_agrees_with_sweep_implementations(counts):
    """The port reproduces the sweep harness's committed transforms
    (examples/scmnc_motor_sweep.py), as jamie_tpu's do."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                    'examples'))
    sweep = pytest.importorskip('scmnc_motor_sweep')
    pairs = [
        (lambda x: nz.log1p(nz.cpm(x, 1e4)), sweep.CANDIDATES['logcpm_1e4']),
        (lambda x: nz.log1p(nz.normalize_total(x)),
         sweep.CANDIDATES['logcpm_median']),
        (nz.normalize_tmm, sweep.CANDIDATES['tmm_log']),
        (nz.normalize_upper_quartile, sweep.CANDIDATES['uq_log']),
        (nz.normalize_quantile, sweep.CANDIDATES['quantile_log']),
        (nz.pearson_residuals, sweep.CANDIDATES['pearson_resid']),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(np.asarray(ours(counts)),
                                   theirs(counts), rtol=1e-9, atol=1e-9)
