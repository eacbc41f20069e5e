"""jamie_tpu_torch.nn_funcs against jamie_tpu.nn_funcs, and the K3
autograd Function (`ops/pairwise.pairwise_euclidean_autograd`) against
autograd and finite differences, on the CPU.

Tolerances: `knn_dist` and `knn_sim` give the same edge set with values
within 1e-5 relative (f32 distances summed in another order; the data have
no near-ties); `uc_loss` and `nlma_loss` values and gradients within 1e-5
relative of jax's; `gw_loss`'s value within 1e-5 relative. `gw_loss`'s
gradient is the deliberate deviation: jamie_tpu's is NaN everywhere (sqrt
at the zero diagonal), the port's is finite and matches float64 central
differences within 1e-6 relative. The Function's backward passes
`torch.autograd.gradcheck` in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamie_tpu import nn_funcs as ref
from jamie_tpu_torch import nn_funcs as port
from jamie_tpu_torch.ops.pairwise import (pairwise_euclidean_autograd,
                                          pairwise_euclidean_plain)


def _points(seed, n, f, scale=0.5):
    return (scale * np.random.RandomState(seed).randn(n, f)).astype(np.float32)


@pytest.mark.parametrize('k', [3, 5])
def test_knn_dist_matches_reference(k):
    x = _points(0, 40, 4)
    want = ref.knn_dist(x, k=k)
    got = port.knn_dist(x, k=k, device='cpu')
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.array_equal(got, got.T)


def test_knn_dist_bridges_components():
    # two far clusters: the kNN graph alone has two components
    x = np.concatenate([_points(1, 12, 3), _points(2, 12, 3) + 4.0])
    want = ref.knn_dist(x, k=3)
    got = port.knn_dist(x, k=3, device='cpu')
    from scipy.sparse.csgraph import connected_components
    assert connected_components(got > 0)[0] == 1
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_knn_sim_matches_reference():
    corr = np.random.RandomState(3).rand(30, 25).astype(np.float32)
    want = ref.knn_sim(corr, k=4)
    got = port.knn_sim(corr, k=4)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _value_and_grad_pair(ref_fn, port_fn, arrays):
    """jax's and torch's (value, gradients w.r.t. every argument)."""
    v_ref, g_ref = jax.value_and_grad(ref_fn, argnums=tuple(
        range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    v = port_fn(*ts)
    g = torch.autograd.grad(v, ts)
    return (float(v_ref), [np.asarray(a) for a in g_ref],
            float(v.detach()), [a.numpy() for a in g])


def test_uc_loss_value_and_grad():
    p0, p1 = _points(4, 20, 3), _points(5, 15, 3)
    F = np.random.RandomState(6).rand(20, 15).astype(np.float32)
    vr, gr, vp, gp = _value_and_grad_pair(
        lambda a, b, f: ref.uc_loss([a, b], f),
        lambda a, b, f: port.uc_loss([a, b], f), [p0, p1, F])
    assert vp == pytest.approx(vr, rel=1e-5)
    for a, b in zip(gp, gr):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_nlma_loss_value_and_grad():
    rng = np.random.RandomState(7)
    p0, p1 = _points(8, 12, 3), _points(9, 10, 3)
    Wx = (rng.rand(12, 12) > 0.6).astype(np.float32)
    Wy = (rng.rand(10, 10) > 0.6).astype(np.float32)
    Wx, Wy = Wx + Wx.T, Wy + Wy.T
    Wxy = rng.rand(12, 10).astype(np.float32)
    vr, gr, vp, gp = _value_and_grad_pair(
        lambda a, b, wx, wy, wxy: ref.nlma_loss([a, b], wx, wy, wxy, 0.5),
        lambda a, b, wx, wy, wxy: port.nlma_loss([a, b], wx, wy, wxy, 0.5),
        [p0, p1, Wx, Wy, Wxy])
    assert vp == pytest.approx(vr, rel=1e-5)
    for a, b in zip(gp, gr):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_gw_loss_value_matches_reference():
    e0, e1 = _points(10, 6, 3), _points(11, 6, 4)
    want = float(ref.gw_loss([jnp.asarray(e0), jnp.asarray(e1)]))
    got = float(port.gw_loss([torch.tensor(e0), torch.tensor(e1)]))
    assert got == pytest.approx(want, rel=1e-5)


def test_gw_loss_gradient_finite_where_reference_is_nan():
    e0, e1 = _points(10, 6, 3), _points(11, 6, 4)
    g_ref = np.asarray(jax.grad(
        lambda a: ref.gw_loss([a, jnp.asarray(e1)]))(jnp.asarray(e0)))
    assert np.isnan(g_ref).all()            # the reference's fault
    x = torch.tensor(e0, dtype=torch.float64, requires_grad=True)
    y = torch.tensor(e1, dtype=torch.float64)
    (g,) = torch.autograd.grad(port.gw_loss([x, y]), x)
    assert torch.isfinite(g).all()
    # float64 central differences of the loss
    h, num = 1e-6, np.zeros(e0.shape)
    base = x.detach().clone()
    for i in range(e0.shape[0]):
        for j in range(e0.shape[1]):
            for sign in (1, -1):
                z = base.clone()
                z[i, j] += sign * h
                num[i, j] += sign * float(port.gw_loss([z, y])) / (2 * h)
    np.testing.assert_allclose(g.numpy(), num, rtol=1e-6,
                               atol=1e-6 * np.abs(num).max())


@pytest.mark.parametrize('squared', [True, False])
@pytest.mark.parametrize('cross', [False, True])
def test_pairwise_autograd_gradcheck(squared, cross):
    x = torch.tensor(_points(12, 7, 3), dtype=torch.float64,
                     requires_grad=True)
    y = (torch.tensor(_points(13, 5, 3), dtype=torch.float64,
                      requires_grad=True) if cross else None)
    assert torch.autograd.gradcheck(
        lambda a, b: pairwise_euclidean_autograd(a, b, squared), (x, y))


@pytest.mark.parametrize('squared', [True, False])
def test_pairwise_autograd_matches_plain_autograd(squared):
    x = torch.tensor(_points(14, 30, 4), requires_grad=True)
    y = torch.tensor(_points(15, 20, 4), requires_grad=True)
    up = torch.tensor(np.random.RandomState(16).randn(30, 20),
                      dtype=torch.float32)
    got = torch.autograd.grad(
        (pairwise_euclidean_autograd(x, y, squared) * up).sum(), (x, y))
    want = torch.autograd.grad(
        (pairwise_euclidean_plain(x, y, squared) * up).sum(), (x, y))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_pairwise_autograd_zero_gradient_at_zero_distance():
    # a duplicated row: the sqrt has no derivative at d = 0, so those
    # entries (and the diagonal) pass no gradient instead of NaN; elsewhere
    # the gradient is autograd's through a sqrt guarded at 0
    x = torch.tensor(_points(17, 5, 3))
    x = torch.cat([x, x[:1]]).requires_grad_(True)
    (g,) = torch.autograd.grad(
        pairwise_euclidean_autograd(x, squared=False).sum(), x)
    d2 = pairwise_euclidean_plain(x, squared=True)
    live = d2 > 0
    guarded = torch.where(live, torch.sqrt(torch.where(live, d2, 1.0)), 0.0)
    (want,) = torch.autograd.grad(guarded.sum(), x)
    assert torch.isfinite(g).all()
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)
