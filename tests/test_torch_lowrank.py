"""jamie_tpu_torch.ops.lowrank against jamie_tpu.ops.lowrank on the CPU:
every LowRankF / SparseLandmarkF method and helper on the same seeded
factors. Products and mixtures are float32 with different summation
orders, held at rtol 1e-5 (atol 1e-7 for entries near 0); index results
are compared exactly, on tie-free random data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamie_tpu.ops import lowrank as jl
from jamie_tpu_torch.ops import lowrank as tl

TOL = dict(rtol=1e-5, atol=1e-7)


def _factors(n0=37, n1=29, L0=11, L1=13, k=3, seed=0):
    rng = np.random.RandomState(seed)
    ix = np.stack([rng.choice(L0, k, replace=False) for _ in range(n0)])
    iy = np.stack([rng.choice(L1, k, replace=False) for _ in range(n1)])
    wx = rng.rand(n0, k).astype(np.float32)
    wx /= wx.sum(1, keepdims=True)
    wy = rng.rand(n1, k).astype(np.float32)
    wy /= wy.sum(1, keepdims=True)
    f_l = rng.rand(L0, L1).astype(np.float32)
    return ix, wx, iy, wy, f_l


@pytest.fixture(params=['dense', 'sparse'])
def pair(request):
    """(ours, jamie_tpu's) for the same F in each layout."""
    ix, wx, iy, wy, f_l = _factors(seed=1)
    ref = jl.SparseLandmarkF(ix, wx, iy, wy, f_l)
    if request.param == 'dense':
        ref = jl.LowRankF(np.asarray(ref.u), np.asarray(ref.v))
    ours = tl.from_fields(ref, device='cpu')
    assert type(ours).__name__ == type(ref).__name__
    return ours, ref


def test_factors_and_dense(pair):
    ours, ref = pair
    assert ours.shape == ref.shape and ours.rank == ref.rank
    assert ours.device == torch.device('cpu')
    np.testing.assert_allclose(ours.u.numpy(), np.asarray(ref.u), **TOL)
    np.testing.assert_allclose(ours.v.numpy(), np.asarray(ref.v), **TOL)
    np.testing.assert_allclose(ours.to_dense(), ref.to_dense(), **TOL)
    with pytest.raises(ValueError):
        ours.to_dense(max_entries=100)


def test_gather_batch(pair):
    ours, ref = pair
    idx0 = np.array([0, 5, 36, 2, 2])
    idx1 = np.array([1, 28, 7, 7])
    want = np.asarray(ref.gather_batch(jnp.asarray(idx0), jnp.asarray(idx1)))
    np.testing.assert_allclose(ours.gather_batch(idx0, idx1).numpy(), want,
                               **TOL)
    np.testing.assert_allclose(
        ours.gather_batch(torch.as_tensor(idx0), torch.as_tensor(idx1)).numpy(),
        want, **TOL)


def test_col_sums_and_normalized(pair):
    ours, ref = pair
    np.testing.assert_allclose(ours.col_sums().numpy(),
                               np.asarray(ref.col_sums()), **TOL)
    cn = ours.col_normalized()
    assert type(cn) is type(ours)
    np.testing.assert_allclose(cn.to_dense(), ref.col_normalized().to_dense(),
                               **TOL)


def test_transpose(pair):
    ours, ref = pair
    assert type(ours.T) is type(ours)
    assert ours.T.shape == (ours.shape[1], ours.shape[0])
    np.testing.assert_allclose(ours.T.to_dense(), ref.T.to_dense(), **TOL)


def _same_topk(ours, ref):
    np.testing.assert_array_equal(ours.cols, ref.cols)
    np.testing.assert_allclose(ours.vals, ref.vals, **TOL)


def test_top_k(pair):
    ours, ref = pair
    _same_topk(ours.top_k(4, block=16), ref.top_k(4, block=16))


@pytest.mark.parametrize('col_block', [7, 2, 64])
def test_sparse_top_k_running_merge(col_block):
    """col_block < n1 exercises the running merge, < k the -inf pad."""
    fields = _factors(n0=40, n1=33, seed=3)
    ours = tl.SparseLandmarkF(*fields, device='cpu')
    ref = jl.SparseLandmarkF(*fields)
    _same_topk(ours.top_k(4, block=16, col_block=col_block),
               ref.top_k(4, block=16, col_block=col_block))


def test_helpers_match():
    rng = np.random.RandomState(4)
    ix, wx, iy, wy, f_l = _factors(seed=4)
    t = torch.as_tensor
    np.testing.assert_allclose(
        tl._mix_rows(t(ix), t(wx), t(f_l)).numpy(),
        np.asarray(jl._mix_rows(jnp.asarray(ix), jnp.asarray(wx),
                                jnp.asarray(f_l))), **TOL)
    np.testing.assert_array_equal(
        tl._scatter_rows(t(iy), t(wy), 13).numpy(),
        np.asarray(jl._scatter_rows(jnp.asarray(iy), jnp.asarray(wy), 13)))
    u, v = rng.rand(9, 5).astype(np.float32), rng.rand(12, 5).astype(np.float32)
    vals, cols = tl._block_topk(t(u), t(v), 3)
    rvals, rcols = jl._block_topk(jnp.asarray(u), jnp.asarray(v), 3)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(rcols))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rvals), **TOL)
    best_v = rng.rand(9, 3).astype(np.float32)
    best_c = rng.randint(0, 50, (9, 3))
    scores = rng.rand(9, 2).astype(np.float32)
    mv, mc = tl._topk_merge(t(best_v), t(best_c), t(scores), 50, 3)
    rv, rc = jl._topk_merge(jnp.asarray(best_v), jnp.asarray(best_c, jnp.int32),
                            jnp.asarray(scores), 50, 3)
    np.testing.assert_array_equal(mc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(rv))


def test_layouts_agree():
    """The k-sparse layout is the dense one's F, method by method."""
    fields = _factors(n0=30, n1=25, seed=5)
    sp = tl.SparseLandmarkF(*fields, device='cpu')
    dn = tl.LowRankF(sp.u, sp.v)
    idx0, idx1 = np.arange(0, 30, 3), np.arange(24, -1, -2)
    np.testing.assert_allclose(sp.gather_batch(idx0, idx1).numpy(),
                               dn.gather_batch(idx0, idx1).numpy(), **TOL)
    np.testing.assert_allclose(sp.col_sums().numpy(), dn.col_sums().numpy(),
                               **TOL)
    _same_topk(sp.top_k(3, block=8, col_block=10), dn.top_k(3, block=8))
