"""jamie_tpu_torch.solvers.umap against jamie_tpu.solvers.umap on the CPU,
and the model_pca='umap' fit through the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jamie_tpu.ops.distances import pairwise_distance as jax_distance
from jamie_tpu.solvers import umap as ju
from jamie_tpu_torch.solvers import umap as tu


@pytest.mark.parametrize('min_dist', [0.1, 0.5])
def test_fit_ab_matches_reference(min_dist):
    """The default pair is umap-learn's constant; others come from the
    same scipy curve_fit."""
    assert tu.fit_ab(min_dist, 1.0) == pytest.approx(ju.fit_ab(min_dist, 1.0),
                                                     rel=1e-9)


def test_smooth_knn_matches_reference():
    """rho exactly; sigma within 1e-5 relative (64 bisection steps on
    tie-free rows, float32 exp in two libraries), hitting log2(k)."""
    rng = np.random.RandomState(0)
    knn_d = np.sort(np.abs(rng.randn(50, 15)), axis=1).astype(np.float32)
    rho_r, sigma_r = (np.asarray(a) for a in ju._smooth_knn(jnp.asarray(knn_d)))
    rho, sigma = (a.numpy() for a in tu._smooth_knn(torch.as_tensor(knn_d)))
    np.testing.assert_array_equal(rho, rho_r)
    np.testing.assert_allclose(sigma, sigma_r, rtol=1e-5)
    w = np.exp(-np.maximum(knn_d - rho[:, None], 0) / sigma[:, None])
    np.testing.assert_allclose(w.sum(1), np.log2(15), atol=1e-2)


def _points(n=60, f=8, seed=1):
    return np.random.RandomState(seed).randn(n, f).astype(np.float32)


def test_fuzzy_graph_matches_reference():
    """The same k-neighbour sets (tie-free data) and memberships within
    1e-5; symmetric, in [0, 1], zero diagonal."""
    dist = np.asarray(jax_distance(_points(), 'euclidean'))
    ref = np.asarray(ju._fuzzy_graph(jnp.asarray(dist), 10))
    W = tu._fuzzy_graph(torch.as_tensor(dist), 10).numpy()
    np.testing.assert_array_equal(W != 0, ref != 0)
    np.testing.assert_allclose(W, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(W, W.T, atol=1e-6)
    assert W.min() >= 0.0 and W.max() <= 1.0 + 1e-6
    assert np.all(np.diag(W) == 0)


def test_optimize_layout_without_negatives_matches_reference():
    """neg_rate=0 makes the layout deterministic: 5 epochs of the dense
    attraction from the same start within 1e-4 of the largest coordinate
    (float32 Gram and pow in two libraries)."""
    X = _points()
    W = ju._fuzzy_graph(jnp.asarray(jax_distance(X, 'euclidean')), 10)
    Y0 = (3.0 * np.random.RandomState(2).randn(60, 2)).astype(np.float32)
    a, b = ju.fit_ab()
    import jax
    ref = np.asarray(ju._optimize_layout(W, jnp.asarray(Y0),
                                         jax.random.PRNGKey(0), 5, a, b,
                                         neg_rate=0))
    ours = tu._optimize_layout(torch.as_tensor(np.asarray(W)),
                               torch.as_tensor(Y0), torch.Generator(), 5, a,
                               b, neg_rate=0).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_repulsion_with_fixed_partners_matches_float64():
    """The sampled repulsive term for fixed negative partners against a
    float64 numpy build, within 1e-5 of its largest component."""
    rng = np.random.RandomState(3)
    Y = (2.0 * rng.randn(40, 3)).astype(np.float32)
    idx = rng.randint(0, 40, (40, 5))
    a, b = tu.fit_ab()
    diff = Y[:, None, :].astype(np.float64) - Y[idx]
    d2 = np.maximum((diff * diff).sum(-1), 1e-12)
    rep = 2.0 * b / ((0.001 + d2) * (a * d2 ** b + 1.0))
    ref = np.clip(rep[:, :, None] * diff, -4.0, 4.0).sum(1)
    ours = tu._repulsion(torch.as_tensor(Y), torch.as_tensor(idx), a,
                         b).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_umap_embed_separates_clusters_and_is_seeded():
    """tests/test_umap.py's embedding checks through the port: clusters
    separate, a seed reproduces its embedding and another seed does not."""
    rng = np.random.RandomState(2)
    X = np.vstack([rng.randn(40, 12), rng.randn(40, 12) + 12.0]).astype(
        np.float32)
    emb = tu.umap_embed(X, n_components=2, n_epochs=150, seed=0, device='cpu')
    assert emb.shape == (80, 2) and np.isfinite(emb).all()
    spread = max(emb[:40].std(), emb[40:].std())
    assert np.linalg.norm(emb[:40].mean(0) - emb[40:].mean(0)) > 2.0 * spread
    X = _points(30, 6, seed=3)
    e1 = tu.umap_embed(X, n_epochs=50, seed=7, device='cpu')
    np.testing.assert_array_equal(e1, tu.umap_embed(X, n_epochs=50, seed=7,
                                                    device='cpu'))
    assert not np.allclose(e1, tu.umap_embed(X, n_epochs=50, seed=8,
                                             device='cpu'), atol=1e-5)


def test_umap_tiny_input_guard():
    with pytest.warns(UserWarning, match='umap'):
        emb = tu.umap_embed(np.zeros((2, 4), np.float32), device='cpu')
    assert emb.shape == (2, 2) and not emb.any()


def test_estimator_umap_preclass_end_to_end():
    """tests/test_umap.py's model_pca='umap' fit through the port: fit,
    project, impute."""
    from jamie_tpu_torch import JAMIE
    rng = np.random.RandomState(4)
    z = rng.randn(40, 4).astype(np.float32)
    d1 = (z @ rng.randn(4, 20)).astype(np.float32)
    d2 = (z @ rng.randn(4, 15)).astype(np.float32)
    jm = JAMIE(model_pca='umap', pca_dim=[6, 6], epoch_DNN=20, min_epochs=5,
               batch_size=20, use_early_stop=False, device='cpu')
    emb = jm.fit_transform(dataset=[d1, d2])
    assert emb[0].shape == (40, 32) and np.isfinite(emb[0]).all()
    imp = jm.modal_predict(d1, 0)
    assert imp.shape == (40, 15) and np.isfinite(imp).all()


# ------------------------------------------ the loops' shared steps (CPU)
def _steps(name, sp):
    """The steps of loop `name` under span `sp`, by route."""
    from jamie_tpu_torch.core import timing
    return {k.split('/')[1]: v for k, v in timing.routes(sp).items()
            if k.startswith(name + '/')}


@pytest.mark.parametrize('iters', [1, 7, 64])
def test_smooth_knn_steps_match_reference(iters):
    """The bisection's shared step `iters` times on the 'cpu' route: rho
    exactly, sigma within 1e-5 relative of jamie_tpu's after as many
    fori_loop steps."""
    from jamie_tpu_torch.core import timing
    rng = np.random.RandomState(5)
    knn_d = np.sort(np.abs(rng.randn(40, 15)), axis=1).astype(np.float32)
    rho_r, sigma_r = (np.asarray(a) for a in ju._smooth_knn(
        jnp.asarray(knn_d), iters=iters))
    with timing.span('umap_sigma') as sp:
        rho, sigma = (a.numpy() for a in tu._smooth_knn(
            torch.as_tensor(knn_d), iters=iters))
    assert _steps('umap_sigma', sp) == {'cpu': iters}
    np.testing.assert_array_equal(rho, rho_r)
    np.testing.assert_allclose(sigma, sigma_r, rtol=1e-5)


@pytest.mark.parametrize('n_epochs', [7, 500])
def test_layout_alpha_matches_reference_exactly(n_epochs, monkeypatch):
    """Every epoch's float32 learning rate, from the int32 device counter,
    equals jamie_tpu's lr0 (1 - i / n_epochs) in its jitted fori_loop bit
    for bit (lr0 0.7: the product after the fused subtraction too)."""
    import jax
    seen = []
    real = tu._alpha

    def record(i, rcp, lr0):
        out = real(i, rcp, lr0)
        seen.append(out.clone())
        return out
    monkeypatch.setattr(tu, '_alpha', record)
    W = torch.zeros(5, 5)
    Y0 = torch.as_tensor(np.random.RandomState(0).randn(5, 2),
                         dtype=torch.float32)
    tu._optimize_layout(W, Y0, torch.Generator(), n_epochs, 1.5, 0.9,
                        neg_rate=0, lr0=0.7)

    def body(i, out):
        return out.at[i].set(0.7 * (1.0 - i / n_epochs))
    want = np.asarray(jax.jit(lambda: jax.lax.fori_loop(
        0, n_epochs, body, jnp.zeros(n_epochs, jnp.float32)))())
    got = torch.stack(seen).numpy()
    assert got.dtype == np.float32 and got.shape == (n_epochs,)
    np.testing.assert_array_equal(got, want)


def _layout_case(n=30, dim=3):
    X = _points(n, 6, seed=6)
    W = torch.as_tensor(np.asarray(ju._fuzzy_graph(
        jnp.asarray(jax_distance(X, 'euclidean')), 8)))
    Y0 = torch.as_tensor((3.0 * np.random.RandomState(7).randn(n, dim))
                         .astype(np.float32))
    return W, Y0


def test_optimize_layout_negatives_are_seeded_and_match_float64():
    """neg_rate 5 on the CPU: a seed reproduces the layout, another seed
    changes it, every epoch is one step of the shared loop; one epoch with
    the partners the generator drew matches a float64 transcription of
    jamie_tpu's body (umap.py:126-147) within 1e-5 of the largest
    coordinate."""
    from jamie_tpu_torch.core import timing
    W, Y0 = _layout_case()
    a, b = tu.fit_ab()

    def run(seed, epochs):
        return tu._optimize_layout(W, Y0, torch.Generator().manual_seed(seed),
                                   epochs, a, b, neg_rate=5)
    with timing.span('umap_layout') as sp:
        e1 = run(3, 20)
    assert _steps('umap_layout', sp) == {'cpu': 20}
    np.testing.assert_array_equal(e1.numpy(), run(3, 20).numpy())
    assert not np.allclose(e1.numpy(), run(4, 20).numpy(), atol=1e-5)
    assert torch.equal(Y0, _layout_case()[1])     # the input is not written

    n = Y0.shape[0]
    idx = torch.randint(0, n, (n, 5),
                        generator=torch.Generator().manual_seed(3)).numpy()
    Y, Wd = Y0.numpy().astype(np.float64), W.numpy().astype(np.float64)
    sq = (Y * Y).sum(1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * Y @ Y.T, 1e-12)
    att = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2 ** b + 1.0)
    lim = 4.0 / np.sqrt(d2)
    C = np.clip(att * Wd, -lim, lim)
    g = C.sum(1)[:, None] * Y - C @ Y
    diffn = Y[:, None, :] - Y[idx]
    d2n = np.maximum((diffn * diffn).sum(-1), 1e-12)
    rep = 2.0 * b / ((0.001 + d2n) * (a * d2n ** b + 1.0))
    want = Y + 1.0 * (g + np.clip(rep[:, :, None] * diffn, -4.0, 4.0).sum(1))
    got = run(3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
