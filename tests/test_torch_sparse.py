"""jamie_tpu_torch.ops.sparse against jamie_tpu.ops.sparse on the CPU: every
SparseRows constructor, conversion and reduction on the same seeded inputs
(host numpy in both packages, so equal to float32 summation order), and
sparse_gather_batch under duplicate indices."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch

from jamie_tpu.ops import sparse as js
from jamie_tpu_torch.ops import sparse as ts


def _random_sparse(n0, n1, density, seed=0):
    rng = np.random.RandomState(seed)
    dense = np.where(rng.rand(n0, n1) < density,
                     rng.rand(n0, n1).astype(np.float32), 0.0)
    return dense.astype(np.float32)


def _same(ours, ref):
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.cols, ref.cols)
    np.testing.assert_array_equal(ours.vals, ref.vals)


@pytest.mark.parametrize('build', ['dense', 'coo', 'scipy', 'tuple',
                                   'top_k', 'top_k_signed'])
def test_constructors_match(build):
    dense = _random_sparse(20, 15, 0.2, seed=1)
    r, c = np.nonzero(dense)
    if build == 'dense':
        pair = (ts.SparseRows.from_dense(dense),
                js.SparseRows.from_dense(dense))
    elif build == 'coo':
        pair = (ts.SparseRows.from_coo(r, c, dense[r, c], dense.shape),
                js.SparseRows.from_coo(r, c, dense[r, c], dense.shape))
    elif build == 'scipy':
        pair = (ts.as_sparse_rows(ss.csr_matrix(dense)),
                js.as_sparse_rows(ss.csr_matrix(dense)))
    elif build == 'tuple':
        pair = (ts.as_sparse_rows((r, c, dense[r, c]), shape=(20, 15)),
                js.as_sparse_rows((r, c, dense[r, c], (20, 15))))
    elif build == 'top_k':
        # a tensor input takes the same route as a host array
        pair = (ts.SparseRows.top_k(torch.as_tensor(dense), 3),
                js.SparseRows.top_k(dense, 3))
    else:
        signed = dense - 0.3 * (dense > 0)
        pair = (ts.SparseRows.top_k(signed, 4), js.SparseRows.top_k(signed, 4))
    ours, ref = pair
    _same(ours, ref)
    np.testing.assert_array_equal(ours.to_dense(), ref.to_dense())


def test_conversions_and_reductions_match():
    dense = _random_sparse(14, 9, 0.3, seed=3)
    ours = ts.SparseRows.from_dense(dense)
    ref = js.SparseRows.from_dense(dense)
    np.testing.assert_array_equal(ours.to_dense(), dense)
    np.testing.assert_array_equal(ours.pairs(), ref.pairs())
    _same(ours.T, ref.T)
    _same(ours.transpose().T, ref)
    assert ours.nnz == ref.nnz == int((dense != 0).sum())
    np.testing.assert_array_equal(ours.row_sums(), ref.row_sums())
    np.testing.assert_array_equal(ours.col_sums(), ref.col_sums())
    _same(ours.col_normalized(), ref.col_normalized())
    assert ours.is_diagonal() == ref.is_diagonal() is False
    eye = ts.SparseRows.from_dense(np.eye(6, dtype=np.float32))
    assert eye.is_diagonal() and js.SparseRows.from_dense(
        np.eye(6, dtype=np.float32)).is_diagonal()


def _summed_dense(sr):
    """Float64 dense build of a SparseRows' slots, duplicates summed."""
    out = np.zeros(sr.shape)
    rows = np.repeat(np.arange(sr.shape[0]), sr.cols.shape[1])
    keep = sr.cols.ravel() >= 0
    np.add.at(out, (rows[keep], sr.cols.ravel()[keep]),
              sr.vals.ravel()[keep].astype(np.float64))
    return out


def test_to_dense_sums_duplicate_slots():
    """Slots that share a coordinate (duplicate COO entries, or the P and F
    slot tables that final_corr concatenates) sum in to_dense, as in
    col_sums and sparse_gather_batch. jamie_tpu's to_dense keeps only the
    last such slot (ROADMAP.md Queue 3), so this holds the port to a
    float64 build instead: rtol 1e-6, each cell sums at most three float32
    slots."""
    eye = ts.SparseRows.from_dense(np.eye(12, dtype=np.float32))
    top = ts.SparseRows.top_k(_random_sparse(12, 12, 0.5, seed=5)
                              + np.eye(12, dtype=np.float32), 3)
    joined = ts.SparseRows(np.concatenate([eye.cols, top.cols], axis=1),
                           np.concatenate([eye.vals, top.vals], axis=1),
                           (12, 12))
    r = np.array([0, 3, 3, 3, 7])
    c = np.array([2, 4, 4, 4, 1])
    coo = ts.SparseRows.from_coo(r, c, [0.5, 0.25, 0.125, 1.0, 2.0], (9, 6))
    for sr in (joined, coo):
        want = _summed_dense(sr)
        assert (want != 0).sum() < (sr.cols >= 0).sum()   # duplicates exist
        got = sr.to_dense()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got.sum(0), sr.col_sums(), rtol=1e-6)
        np.testing.assert_allclose(got.sum(1), sr.row_sums(), rtol=1e-6)
    assert coo.to_dense()[3, 4] == 1.375


def test_is_sparse_input_matches():
    dense = _random_sparse(6, 5, 0.4, seed=4)
    r, c = np.nonzero(dense)
    for x in (ts.SparseRows.from_dense(dense), ss.csr_matrix(dense),
              (r, c, dense[r, c]), (r, c, dense[r, c], (6, 5)), dense,
              np.ones(6), 'identity'):
        ref_x = (js.SparseRows.from_dense(dense)
                 if isinstance(x, ts.SparseRows) else x)
        assert ts.is_sparse_input(x) == js.is_sparse_input(ref_x)
    with pytest.raises(TypeError):
        ts.as_sparse_rows(dense)


def test_gather_batch_exact_with_duplicates():
    """Duplicate row and column indices (hybrid sampling draws with
    replacement) and duplicate coordinates in the COO input (summed in one
    row's slots) give exactly the dense block, as in jamie_tpu."""
    dense = _random_sparse(30, 25, 0.2, seed=4)
    r, c = np.nonzero(dense)
    r = np.concatenate([r, r[:5]])
    c = np.concatenate([c, c[:5]])
    v = np.concatenate([dense[r[:-5], c[:-5]], np.full(5, 0.25, np.float32)])
    want = np.zeros_like(dense)
    np.add.at(want, (r, c), v)
    ours = ts.SparseRows.from_coo(r, c, v, dense.shape)
    ref = js.SparseRows.from_coo(r, c, v, dense.shape)
    rng = np.random.RandomState(0)
    idx0 = rng.randint(0, 30, 16)
    idx1 = rng.randint(0, 25, 16)
    assert len(np.unique(idx0)) < 16 and len(np.unique(idx1)) < 16
    got = ts.sparse_gather_batch(torch.as_tensor(ours.cols.astype(np.int64)),
                                 torch.as_tensor(ours.vals),
                                 torch.as_tensor(idx0), torch.as_tensor(idx1))
    ref_out = js.sparse_gather_batch(jnp.asarray(ref.cols),
                                     jnp.asarray(ref.vals),
                                     jnp.asarray(idx0), jnp.asarray(idx1))
    # each output cell sums at most two slots: exact up to their order
    np.testing.assert_allclose(got.numpy(), want[np.ix_(idx0, idx1)],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_out), rtol=1e-6,
                               atol=0)
