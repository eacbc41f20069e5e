"""jamie_tpu_torch.solvers.lowrank (corr_method='jamie') on the CPU: the
two losses' autograd gradients against a float64 build of their analytic
gradients, the RMSprop step against optax's, and the binarized output.
jamie_tpu draws the factors and masks from a jax key, the port from a
torch.Generator, so the fitted correspondences are compared by their
properties."""

import numpy as np
import pytest
import torch

from jamie_tpu_torch.solvers import lowrank as lr


def _sym(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3)
    return ((x[:, None] - x[None]) ** 2).sum(-1)       # float64


def _grads(loss, params):
    ps = [torch.as_tensor(p, dtype=torch.float32).requires_grad_()
          for p in params]
    return [g.numpy() for g in torch.autograd.grad(loss(*ps), ps)]


def test_cluster_loss_gradient_matches_float64():
    """d/dT of ||t Kx t^T - s Ky s^T||^2 with masked columns: 2 (D + D^T)
    t K masked, within 1e-4 of the largest entry (float32 chains of three
    products)."""
    rng = np.random.RandomState(0)
    Kx, Ky = _sym(12, 1), _sym(9, 2)
    Tx, Ty = rng.rand(4, 12), rng.rand(4, 9)
    mx = (rng.rand(12) > 0.5).astype(np.float64)
    my = (rng.rand(9) > 0.5).astype(np.float64)
    tx, ty = Tx * mx, Ty * my
    D = tx @ Kx @ tx.T - ty @ Ky @ ty.T
    ref = [2 * (D + D.T) @ tx @ Kx * mx, -2 * (D + D.T) @ ty @ Ky * my]
    Kxt, Kyt, mxt, myt = (torch.as_tensor(a, dtype=torch.float32)
                          for a in (Kx, Ky, mx, my))
    ours = _grads(lambda a, b: lr._cluster_loss(a, b, Kxt, Kyt, mxt, myt),
                  [Tx, Ty])
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_cast_loss_gradient_matches_float64():
    """d/da and d/dF of ||a Kx - Fc Ky Fc^T||^2, Fc = Tx^T F Ty, within
    1e-4 of the largest entry."""
    rng = np.random.RandomState(3)
    Kx, Ky = _sym(10, 4), _sym(8, 5)
    Tx, Ty, F, a = rng.rand(4, 10), rng.rand(4, 8), rng.rand(4, 4), rng.rand(1)
    Fc = Tx.T @ F @ Ty
    E = a * Kx - Fc @ Ky @ Fc.T
    dFc = -2 * (E @ Fc @ Ky + E.T @ Fc @ Ky)
    ref = [np.array([2 * np.sum(E * Kx)]), Tx @ dFc @ Ty.T]
    Txt, Tyt, Kxt, Kyt = (torch.as_tensor(v, dtype=torch.float32)
                          for v in (Tx, Ty, Kx, Ky))
    ours = _grads(lambda a_, F_: lr._cast_loss(a_, F_, Txt, Tyt, Kxt, Kyt),
                  [a, F])
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_rmsprop_matches_optax():
    """Five steps of the in-place update against optax.rmsprop on the same
    gradients: decay 0.9, g / sqrt(nu + 1e-8), nu from 0 (float32)."""
    import jax.numpy as jnp
    import optax
    rng = np.random.RandomState(6)
    p0 = rng.randn(3, 4).astype(np.float32)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(5)]
    tx = optax.rmsprop(0.1)
    ref, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.as_tensor(p0.copy())
    nu = torch.zeros_like(p)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, ref)
        ref = optax.apply_updates(ref, upd)
        lr._rmsprop([p], [torch.as_tensor(g)], [nu], 0.1)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_lowrank_corr_binarized_rows_and_seed():
    """k ones in every row, zeros elsewhere, reproducible for a seed."""
    Kx, Ky = _sym(15, 7), _sym(11, 8)
    out = lr.lowrank_corr(Kx, Ky, dim=4, epochs=30, topk=3, device='cpu')
    assert out.shape == (15, 11) and out.dtype == torch.float32
    assert set(np.unique(out.numpy())) == {0.0, 1.0}
    np.testing.assert_array_equal(out.sum(1).numpy(), np.full(15, 3.0))
    again = lr.lowrank_corr(Kx, Ky, dim=4, epochs=30, topk=3, device='cpu')
    np.testing.assert_array_equal(out.numpy(), again.numpy())


def test_estimator_corr_method_jamie(synthetic_pair):
    """JAMIE(corr_method='jamie').match() warns as jamie_tpu does and
    returns the binarized F with 5 ones per row (the reference's
    defaults, 10,001 steps per phase, on 40 cells)."""
    from jamie_tpu_torch import JAMIE
    data = [d[:40] for d in synthetic_pair[0]]
    jm = JAMIE(corr_method='jamie', distance_mode='euclidean', device='cpu')
    jm.dataset, jm.dataset_num = data, 2
    jm.col = [d.shape[1] for d in data]
    jm.compute_distances()
    with pytest.warns(UserWarning, match='WIP'):
        (F,) = jm.match()
    assert F.shape == (40, 40)
    np.testing.assert_array_equal(F.sum(1).numpy(), np.full(40, 5.0))


@pytest.mark.parametrize('topk', [1, 3])
def test_lowrank_corr_properties_match_reference(topk):
    """Both packages' binarized correspondences on the same distances:
    (n, m), only 0 and 1, `topk` ones in every row. The two random streams
    differ (a jax key against a torch.Generator), so the ones themselves
    are not compared."""
    from jamie_tpu.solvers.lowrank import lowrank_corr as jax_lowrank_corr
    Kx, Ky = _sym(14, 9), _sym(10, 10)
    ref = np.asarray(jax_lowrank_corr(Kx, Ky, dim=4, epochs=40, topk=topk))
    ours = lr.lowrank_corr(Kx, Ky, dim=4, epochs=40, topk=topk,
                           device='cpu').numpy()
    for out in (ref, ours):
        assert out.shape == (14, 10)
        assert set(np.unique(out)) == {0.0, 1.0}
        np.testing.assert_array_equal(out.sum(1), np.full(14, float(topk)))


def test_optimize_steps_draw_new_masks_in_the_step():
    """The clustering step draws its masks inside the step from the
    registered generator (what a captured replay draws anew on the card):
    every step draws new ones, kept at keep_prob on average (as jamie_tpu's
    fold_in of the step number gives), and 30 steps of `_optimize` equal a
    hand-written loop of loss, autograd and RMSprop from the same
    generator, the factors and the generator's state exactly."""
    Kx = torch.as_tensor(_sym(40, 3), dtype=torch.float32)
    outs = []
    for by_hand in (False, True):
        gen = torch.Generator().manual_seed(2)
        T = torch.rand(3, 40, generator=gen).requires_grad_()
        masks = []

        def loss(T):
            m = (torch.rand(40, generator=gen) > 0.65).float()
            masks.append(m)
            return lr._cluster_loss(T, T.detach() * 0.5, Kx, Kx, m, m)
        if by_hand:
            nu = torch.zeros_like(T)
            for _ in range(30):
                lr._rmsprop([T], torch.autograd.grad(loss(T), [T]), [nu],
                            0.01)
        else:
            lr._optimize('test', loss, [T], 30, 0.01, 'cpu', gen)
        outs.append((T.detach().clone(), gen.get_state(), masks))
    (t1, s1, m1), (t2, s2, m2) = outs
    torch.testing.assert_close(t1, t2, rtol=0, atol=0)
    assert torch.equal(s1, s2)
    assert len(m1) == 30 and all(not torch.equal(a, b)
                                 for a, b in zip(m1, m1[1:]))
    assert abs(float(torch.stack(m1).mean()) - 0.35) < 0.05
