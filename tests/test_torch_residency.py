"""jamie_tpu_torch.core.residency against jamie_tpu.core.residency on the
CPU: DeviceCSR's products, decode and row norms (tests/test_spmm.py's
fixtures), the bf16 rounding rule, the residency caches' guards
(tests/test_residency_guards.py) and ChunkUploader's blocks.

Tolerances: below BF16_LINK_ELEMS both packages keep exact f32 values, so
products agree with a float64 reference to f32 summation order (rtol 1e-4,
atol 1e-5, as test_spmm.py holds jamie_tpu) and with each other to the same;
decodes and bf16 residencies are bit-identical."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from jamie_tpu.core import residency as jr
from jamie_tpu_torch.core import residency as tr


def _rand_csr(rng, n, f, density, empty_row_stretch=0):
    X = sp.random(n, f, density=density, format='csr', random_state=rng,
                  dtype=np.float32)
    if empty_row_stretch:
        lil = X.tolil()
        lil[n // 3:n // 3 + empty_row_stretch] = 0
        X = lil.tocsr()
    X.sort_indices()
    return X


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _ref_matmul(X, M, s=0, e=None):
    e = X.shape[0] if e is None else e
    return (X[s:e].toarray().astype(np.float64)
            @ M.astype(np.float64)).astype(np.float32)


def _dev(X):
    return tr.DeviceCSR(X, 'cpu')


@pytest.fixture(autouse=True)
def _fresh_caches():
    tr.clear_residency_cache()
    jr.clear_residency_cache()
    yield
    tr.clear_residency_cache()
    jr.clear_residency_cache()


@pytest.mark.parametrize('n,f,density,k', [
    (300, 200, 0.05, 7),
    (1000, 64, 0.02, 33),
    (97, 5000, 0.001, 4),     # wide + very sparse
    (513, 300, 0.5, 130),     # dense-ish
])
def test_matmul_matches_dense_and_reference(n, f, density, k):
    rng = np.random.RandomState(0)
    X = _rand_csr(rng, n, f, density)
    M = rng.randn(f, k).astype(np.float32)
    out = _dev(X).matmul(M).numpy()
    np.testing.assert_allclose(out, _ref_matmul(X, M), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jr.DeviceCSR(X).matmul(M)),
                               rtol=1e-4, atol=1e-5)


def test_matmul_row_blocks():
    rng = np.random.RandomState(1)
    X = _rand_csr(rng, 400, 150, 0.07)
    M = rng.randn(150, 9).astype(np.float32)
    d = _dev(X)
    for s, e in [(0, 400), (0, 37), (37, 211), (211, 400), (399, 400),
                 (300, 10 ** 6)]:
        np.testing.assert_allclose(d.matmul(M, s, e).numpy(),
                                   _ref_matmul(X, M, s, min(e, 400)),
                                   rtol=1e-4, atol=1e-5)


def test_matmul_empty_rows_and_blocks():
    rng = np.random.RandomState(2)
    X = _rand_csr(rng, 500, 80, 0.05, empty_row_stretch=120)
    M = rng.randn(80, 5).astype(np.float32)
    d = _dev(X)
    np.testing.assert_allclose(d.matmul(M).numpy(), _ref_matmul(X, M),
                               rtol=1e-4, atol=1e-5)
    s, e = 500 // 3 + 5, 500 // 3 + 60     # a block inside the empty rows
    blk = d.matmul(M, s, e).numpy()
    assert blk.shape == (e - s, 5) and not blk.any()
    assert not d.rows(s, e).numpy().any()


def test_matmul_all_zero_matrix():
    X = sp.csr_matrix((64, 32), dtype=np.float32)
    d = _dev(X)
    out = d.matmul(np.ones((32, 3), np.float32)).numpy()
    assert out.shape == (64, 3) and not out.any()
    assert d.tmatmul(np.ones((64, 2), np.float32)).shape == (32, 2)
    assert not d.row_sq_sums().numpy().any()
    assert d.rows(0, 64).shape == (64, 32)


def test_tmatmul_matches_dense():
    rng = np.random.RandomState(3)
    X = _rand_csr(rng, 250, 180, 0.04)
    Q = rng.randn(250, 11).astype(np.float32)
    d = _dev(X)
    out = d.tmatmul(Q).numpy()       # (f, k) = X^T Q
    ref = (X.toarray().astype(np.float64).T
           @ Q.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jr.DeviceCSR(X).tmatmul(Q)),
                               rtol=1e-4, atol=1e-5)
    d.release_csc()                  # a later product rebuilds the twin
    np.testing.assert_array_equal(d.tmatmul(Q).numpy(), out)


def test_tmatmul_by_row_blocks(monkeypatch):
    """The transposed twin is built by blocks of TWIN_ROWS rows (a block
    with no nonzero left out), and X^T Q sums the blocks' products; each
    product's sizes go to the open span's `spmm` counter."""
    from jamie_tpu_torch.core import residency as res, timing
    rng = np.random.RandomState(5)
    X = _rand_csr(rng, 250, 180, 0.04).tolil()
    X[64:128] = 0
    X = X.tocsr()
    Q = rng.randn(250, 7).astype(np.float32)
    monkeypatch.setattr(res, 'TWIN_ROWS', 64)
    d = _dev(X)
    with timing.span('t') as sp:
        out = d.tmatmul(Q).numpy()
    assert [(s, e) for s, e, _ in d._csc] == [(0, 64), (128, 192),
                                              (192, 250)]
    ref = (X.toarray().astype(np.float64).T
           @ Q.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    assert [c[1:] for c in sp.counters['spmm']] == [[7, 64, 180],
                                                    [7, 64, 180],
                                                    [7, 58, 180]]
    assert sum(c[0] for c in sp.counters['spmm']) == X.nnz


def test_tmatmul_empty_columns():
    rng = np.random.RandomState(4)
    X = _rand_csr(rng, 120, 90, 0.03).tolil()
    X[:, 30:55] = 0
    X = X.tocsr()
    X.sort_indices()
    Q = rng.randn(120, 6).astype(np.float32)
    out = _dev(X).tmatmul(Q).numpy()
    ref = (X.toarray().astype(np.float64).T
           @ Q.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    assert np.all(out[30:55] == 0)


def test_row_sq_sums_and_rows():
    rng = np.random.RandomState(5)
    X = _rand_csr(rng, 300, 70, 0.06, empty_row_stretch=40)
    d = _dev(X)
    sq = d.row_sq_sums().numpy()
    np.testing.assert_allclose(sq, (X.toarray() ** 2).sum(axis=1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sq, np.asarray(jr.DeviceCSR(X).row_sq_sums()),
                               rtol=1e-5, atol=1e-6)
    # the dense decode is exact, and identical to jamie_tpu's
    for s, e in [(0, 300), (17, 140), (299, 300)]:
        np.testing.assert_array_equal(d.rows(s, e).numpy(),
                                      X[s:e].toarray())
        np.testing.assert_array_equal(
            d.rows(s, e).numpy(), np.asarray(jr.DeviceCSR(X).rows(s, e)))


def test_matmul_bf16_at_scale(monkeypatch):
    """At or above BF16_LINK_ELEMS (patched) the values and the SpMM's
    operand round to bf16 in both packages; below it they stay exact."""
    monkeypatch.setattr(tr, 'BF16_LINK_ELEMS', 80 * 60)
    monkeypatch.setattr(jr, 'BF16_LINK_ELEMS', 80 * 60)
    rng = np.random.RandomState(9)
    X = _rand_csr(rng, 80, 60, 0.2)
    M = rng.randn(60, 5).astype(np.float32)
    Q = rng.randn(80, 4).astype(np.float32)
    d, j = _dev(X), jr.DeviceCSR(X)
    assert d.bf16 and str(j.ev.dtype) == 'bfloat16'
    ref = (_bf16(X.toarray()).astype(np.float64)
           @ _bf16(M).astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(d.matmul(M).numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(d.matmul(M).numpy(), np.asarray(j.matmul(M)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d.tmatmul(Q).numpy(), np.asarray(j.tmatmul(Q)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(d.rows(0, 80).numpy(),
                                  np.asarray(j.rows(0, 80)))
    np.testing.assert_allclose(d.row_sq_sums().numpy(),
                               np.asarray(j.row_sq_sums()), rtol=1e-5)
    monkeypatch.setattr(tr, 'BF16_LINK_ELEMS', 80 * 60 + 1)
    assert not _dev(X).bf16


def test_noncanonical_duplicates_sum_and_caller_untouched():
    rows = np.array([0, 0, 1, 2, 2, 2], np.int32)
    cols = np.array([3, 3, 1, 0, 0, 4], np.int32)
    vals = np.array([1.0, 2.0, 5.0, 0.5, 0.25, 7.0], np.float32)
    X = sp.csr_matrix((vals, cols, np.array([0, 2, 3, 6, 6], np.int32)),
                      shape=(4, 6))
    del rows
    assert not X.has_canonical_format
    nnz_before, data_before = int(X.nnz), X.data.copy()
    dense = X.toarray()                    # scipy sums duplicates
    d = _dev(X)
    np.testing.assert_array_equal(d.rows(0, 4).numpy(), dense)
    np.testing.assert_allclose(d.matmul(np.eye(6, dtype=np.float32)).numpy(),
                               dense, rtol=1e-6)
    np.testing.assert_allclose(d.row_sq_sums().numpy(),
                               (dense ** 2).sum(1), rtol=1e-6)
    assert int(X.nnz) == nnz_before and not X.has_canonical_format
    np.testing.assert_array_equal(X.data, data_before)
    # a non-canonical chunk streamed by the uploader sums them too
    np.testing.assert_array_equal(
        tr.ChunkUploader(X, 'cpu').cols(0, 6).numpy(), dense)


@pytest.mark.parametrize('source', ['dense', 'csr', 'csr_over_budget'])
def test_device_bf16_bit_identical_to_reference(source, monkeypatch):
    """The resident bf16 matrix, compared as uint16 bit patterns, over
    several row chunks: the dense source cast on the host, the CSR source
    decoded from its DeviceCSR or, past the CSR budget, chunk by chunk."""
    rng = np.random.RandomState(6)
    x = rng.randn(150, 90).astype(np.float32)
    x[rng.rand(150, 90) < 0.7] = 0
    arr = x if source == 'dense' else sp.csr_matrix(x)
    if source == 'csr_over_budget':
        monkeypatch.setattr(tr, 'DEFAULT_BUDGET_BYTES', 1000)
        monkeypatch.setattr(jr, 'DEFAULT_BUDGET_BYTES', 1000)
        assert tr.device_csr(arr, device='cpu') is None
    ours = tr.build_resident_bf16(arr, 'cpu', chunk_bytes=90 * 2 * 40)
    ref = np.asarray(jr.build_resident_bf16(arr))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.view(torch.int16).numpy().view(
        np.uint16), ref.view(np.uint16))
    if source != 'csr_over_budget':
        assert torch.equal(tr.device_bf16(arr, device='cpu'), ours)


def test_device_bf16_budget_and_identity_keying(monkeypatch):
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    a = tr.device_bf16(x, device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert tr.device_bf16(x, device='cpu') is a      # same array: hit
    copy = x.copy()
    assert tr.device_bf16(copy, device='cpu') is not a   # equal copy: miss
    assert tr.device_bf16(x, budget_bytes=64 * 32 * 2 - 1,
                          device='cpu') is None
    assert tr.device_bf16([[1.0]], device='cpu') is None  # not an array
    monkeypatch.setattr(tr, 'DEFAULT_BUDGET_BYTES', 64 * 32 * 2 - 1)
    assert tr.device_bf16(np.ones((64, 32), np.float32), device='cpu') is None


def test_device_bf16_detects_inplace_mutation():
    X = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    a = tr.device_bf16(X, device='cpu')
    X[0, 7] += 100.0          # in-place mutation the id() key can't see
    with pytest.warns(UserWarning, match='mutated in place'):
        b = tr.device_bf16(X, device='cpu')
    assert b is not a
    assert float(b[0, 7]) == float(torch.tensor(X[0, 7]).bfloat16())


def test_device_csr_detects_inplace_mutation_and_budget():
    rng = np.random.RandomState(1)
    X = sp.random(80, 40, density=0.2, format='csr', random_state=rng,
                  dtype=np.float32)
    X.sum_duplicates()
    a = tr.device_csr(X, budget_bytes=1 << 30, device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert tr.device_csr(X, budget_bytes=1 << 30, device='cpu') is a
    X.data[0] += 50.0
    with pytest.warns(UserWarning, match='mutated in place'):
        b = tr.device_csr(X, budget_bytes=1 << 30, device='cpu')
    assert b is not a
    np.testing.assert_array_equal(b.rows(0, 80).numpy(), X.toarray())
    # jamie_tpu's estimate of its own layout: 4 bytes a nonzero here
    est = 4 * X.nnz + 4 * 81
    assert tr.device_csr(X.copy(), budget_bytes=est, device='cpu') is not None
    assert tr.device_csr(X.copy(), budget_bytes=est - 1, device='cpu') is None
    assert tr.device_csr(X.tocsc(), device='cpu') is None
    assert tr.device_csr(X.toarray(), device='cpu') is None


def test_clear_residency_cache():
    x = np.random.RandomState(2).randn(20, 10).astype(np.float32)
    X = sp.csr_matrix(x)
    a, c = tr.device_bf16(x, device='cpu'), tr.device_csr(X, device='cpu')
    tr.clear_residency_cache()
    assert tr.device_bf16(x, device='cpu') is not a
    assert tr.device_csr(X, device='cpu') is not c


def test_cache_entry_dies_with_host_array():
    x = np.random.RandomState(3).randn(20, 10).astype(np.float32)
    tr.device_bf16(x, device='cpu')
    assert len(tr._cache) == 1
    del x
    assert len(tr._cache) == 0


@pytest.mark.parametrize('rounded', [False, True])
@pytest.mark.parametrize('source', ['dense', 'csr', 'csc'])
def test_chunk_uploader_rows_and_cols(source, rounded, monkeypatch):
    """Blocks equal jamie_tpu's ChunkUploader blocks: exact f32 below
    BF16_LINK_ELEMS, bf16-rounded at or above it (patched)."""
    limit = 120 * 50 if rounded else 120 * 50 + 1
    monkeypatch.setattr(tr, 'BF16_LINK_ELEMS', limit)
    monkeypatch.setattr(jr, 'BF16_LINK_ELEMS', limit)
    rng = np.random.RandomState(7)
    x = (rng.randn(120, 50) * 3).astype(np.float32)
    x[rng.rand(120, 50) < 0.6] = 0
    arr = {'dense': x, 'csr': sp.csr_matrix(x), 'csc': sp.csc_matrix(x)}[
        source]
    ours, ref = tr.ChunkUploader(arr, 'cpu'), jr.ChunkUploader(arr)
    assert ours.exact == ref.exact == (not rounded)
    assert (ours.dcsr is not None) == (source == 'csr')
    want = _bf16(x) if rounded else x
    for s, e in [(0, 33), (33, 120), (100, 500)]:
        got = ours.rows(s, e).numpy()
        np.testing.assert_array_equal(got, want[s:e])
        if source != 'csc':
            # jamie_tpu's encoder reads a CSC row block's arrays as CSR
            # (no caller streams rows of a CSC); held to the truth above
            np.testing.assert_array_equal(got, np.asarray(ref.rows(s, e)))
    for s, e in [(0, 17), (17, 50), (40, 90)]:
        got = ours.cols(s, e).numpy()
        np.testing.assert_array_equal(got, want[:, s:e])
        np.testing.assert_array_equal(got, np.asarray(ref.cols(s, e)))
