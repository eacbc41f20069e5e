"""jamie_tpu_torch.compare against jamie_tpu.compare on the CPU.

Tolerances: NLMA, LMA and CCA embeddings equal up to a per-column sign
within 1e-4 of their largest entry, on data whose leading generalized
eigenvalues are simple (eigenvectors are defined only up to sign), and
their FOSCTTM within 0.005. LMA and CCA on a modality wider than its rows
raise ValueError where jamie_tpu returns NaN (the deliberate deviation).
MMD-MA with jamie_tpu's initial a1, a2 injected: `_mmdma_opt` after 100
steps and `mmdma_embed`'s selected run within 1e-5 of the largest entry,
the final MMD^2 within 1e-5 absolute.
UnionCom is the port's own tsne-mode JAMIE with UnionCom's defaults, run
small here (epoch_pd 40, tsne_iters 30).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamie_tpu import compare as ref
from jamie_tpu_torch import compare as port


@pytest.fixture(scope='module')
def graded():
    """Two modalities of one 6-dimensional latent, the second seeing each
    latent direction through noise of a different scale, so the
    generalized eigenvalues are well separated (seed chosen so)."""
    rng = np.random.RandomState(2)
    noise = np.array([0.2, 0.4, 0.8, 1.6, 3.2, 6.4])
    z = rng.randn(60, 6)
    x0 = z @ rng.randn(6, 8) + 0.3 * rng.randn(60, 8)
    x1 = (z + noise * rng.randn(60, 6)) @ rng.randn(6, 6)
    labels = (z[:, 0] > 0).astype(int).astype(str)
    return [x0.astype(np.float32), x1.astype(np.float32)], [labels, labels]


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _foscttm(emb):
    from jamie_tpu_torch.evaluation import test_closer
    return _quiet(test_closer, emb, device='cpu')


def _same_up_to_sign(got, want, tol):
    for g, w in zip(got, want):
        sign = np.sign((g * w).sum(0))
        np.testing.assert_allclose(g * sign, w, rtol=0,
                                   atol=tol * np.abs(w).max())


@pytest.mark.parametrize('method', ['nlma_embed', 'lma_embed', 'cca_embed'])
def test_eigen_methods_match_reference(graded, method):
    data, _ = graded
    want = getattr(ref, method)(data, output_dim=4)
    got = getattr(port, method)(data, output_dim=4, device='cpu')
    assert [g.shape for g in got] == [(60, 4), (60, 4)]
    _same_up_to_sign(got, want, 1e-4)
    assert abs(_foscttm(got) - _foscttm(want)) <= 0.005


def test_explicit_partial_prior_matches_reference(graded):
    data, _ = graded
    P = np.zeros((60, 60), np.float32)
    P[np.arange(30), np.arange(30)] = 1
    for method in ('nlma_embed', 'cca_embed'):
        want = getattr(ref, method)(data, P=P, output_dim=3)
        got = getattr(port, method)(data, P=P, output_dim=3, device='cpu')
        _same_up_to_sign(got, want, 1e-4)


def test_binary_knn_matches_reference(graded):
    data, _ = graded
    for x in data:
        np.testing.assert_array_equal(port._binary_knn(x, 5, 'cpu'),
                                      ref._binary_knn(x, 5))


def _wide():
    """More features than rows in each modality: B = Z^T D Z is singular."""
    rng = np.random.RandomState(0)
    z = rng.randn(40, 8)
    x0 = np.maximum(z @ rng.randn(8, 300) + .5 * rng.randn(40, 300), 0)
    x1 = (z @ rng.randn(8, 500) + .5 * rng.randn(40, 500) > .5) * 1.0
    return [x0.astype(np.float32), x1.astype(np.float32)]


@pytest.mark.parametrize('method', ['lma_embed', 'cca_embed'])
def test_singular_lma_raises_where_reference_returns_nan(method):
    data = _wide()
    assert np.isnan(getattr(ref, method)(data, output_dim=8)[0]).any()
    with pytest.raises(ValueError, match='exceeds the rank'):
        getattr(port, method)(data, output_dim=8, device='cpu')


@pytest.fixture(scope='module')
def mmd_case():
    rng = np.random.RandomState(0)
    z = rng.randn(40, 4)
    data = [(z @ rng.randn(4, 12) + .1 * rng.randn(40, 12)).astype(np.float32),
            (z @ rng.randn(4, 9) + .1 * rng.randn(40, 9)).astype(np.float32)]
    # jamie_tpu's own initial draws (mmdma_embed, seed 0, 1 restart)
    B, p = 12, 8
    keys = jax.random.split(jax.random.PRNGKey(0), 2 * B)
    a1 = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (40, p), jnp.float32) * 1e-2)(keys[:B]))
    a2 = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (40, p), jnp.float32) * 1e-2)(keys[B:]))
    return data, a1, a2


def test_mmdma_opt_matches_reference(mmd_case):
    data, a1, a2 = mmd_case
    Ks = []
    for d in data:
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        Ks.append(d @ d.T)
    runs = [(0, 0.05, 1e-2, 1e-3), (5, 0.3, 1e-3, 1e-4)]
    E1, E2, mmd = port._mmdma_opt(
        torch.tensor(Ks[0]), torch.tensor(Ks[1]),
        torch.tensor(a1[[r[0] for r in runs]]),
        torch.tensor(a2[[r[0] for r in runs]]),
        *(torch.tensor([r[i] for r in runs], dtype=torch.float32)
          for i in (1, 2, 3)), 8, 100)
    for b, (i, s, l1, l2) in enumerate(runs):
        R1, R2, rm = ref._mmdma_opt(jnp.asarray(Ks[0]), jnp.asarray(Ks[1]),
                                    jnp.asarray(a1[i]), jnp.asarray(a2[i]),
                                    s, l1, l2, 8, 100)
        for g, w in ((E1[b], R1), (E2[b], R2)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
        # MMD^2 is a difference of kernel means (each <= 1)
        assert float(mmd[b]) == pytest.approx(float(rm), abs=1e-5)


def test_mmdma_embed_selects_the_reference_run(mmd_case):
    data, a1, a2 = mmd_case
    want = ref.mmdma_embed(data, output_dim=8, n_iters=100, n_restarts=1)
    got = port.mmdma_embed(data, output_dim=8, n_iters=100, n_restarts=1,
                           init=(a1, a2), device='cpu')
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_mmdma_embed_seeded_draws_are_reproducible(mmd_case):
    data, _, _ = mmd_case
    kw = dict(output_dim=4, n_iters=5, n_restarts=1, sigma_scales=(1.0,),
              lambda1_grid=(1e-2,), lambda2_grid=(1e-3,), device='cpu')
    a = port.mmdma_embed(data, seed=3, **kw)
    b = port.mmdma_embed(data, seed=3, **kw)
    c = port.mmdma_embed(data, seed=4, **kw)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])


def test_unioncom_defaults(monkeypatch):
    from jamie_tpu_torch import estimator
    seen = {}

    class Stub:
        def __init__(self, **kw):
            seen.update(kw)

        def fit_transform(self, dataset):
            return dataset

    monkeypatch.setattr(estimator, 'JAMIE', Stub)
    port.unioncom_embed([np.zeros((3, 2))] * 2, device='cpu')
    assert seen == dict(project_mode='tsne', output_dim=32,
                        distance_mode='geodesic', epoch_pd=20000,
                        tsne_iters=3000, device='cpu')


def test_compare_methods_scores_like_reference(graded):
    data, labels = graded
    kw = {'MMD-MA': dict(n_iters=20, n_restarts=1),
          'UnionCom': dict(epoch_pd=40, tsne_iters=30)}
    got = _quiet(port.compare_methods, data, labels,
                 methods=('NLMA', 'CCA', 'MMD-MA', 'UnionCom'), output_dim=4,
                 method_kwargs=kw, device='cpu')
    want = _quiet(ref.compare_methods, data, labels, methods=('NLMA', 'CCA'),
                  output_dim=4)
    for name, entry in got.items():
        assert set(entry) == {'embeddings', 'foscttm', 'lta'}
        assert all(e.shape == (60, 4) and np.isfinite(e).all()
                   for e in entry['embeddings'])
        assert 0 <= entry['foscttm'] <= 1 and 0 <= entry['lta'] <= 1
    for name in want:
        assert got[name]['foscttm'] == pytest.approx(want[name]['foscttm'],
                                                     abs=0.005)
        assert got[name]['lta'] == pytest.approx(want[name]['lta'], abs=0.02)


@pytest.mark.parametrize('n_iters', [1, 2, 100])
def test_mmdma_opt_device_counter_matches_reference(mmd_case, n_iters):
    """The shared step with its int32 step counter on the device (Adam's
    bias corrections computed from it), n_iters times on the 'cpu' route,
    against jamie_tpu's fori_loop from the same injected a1, a2: within
    1e-5 of the largest entry, the final MMD^2 within 1e-5 absolute."""
    from jamie_tpu_torch.core import timing
    data, a1, a2 = mmd_case
    Ks = []
    for d in data:
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        Ks.append(d @ d.T)
    runs = [(1, 0.1, 1e-2, 1e-4), (7, 0.6, 1e-3, 1e-3)]
    with timing.span('mmdma') as sp:
        E1, E2, mmd = port._mmdma_opt(
            torch.tensor(Ks[0]), torch.tensor(Ks[1]),
            torch.tensor(a1[[r[0] for r in runs]]),
            torch.tensor(a2[[r[0] for r in runs]]),
            *(torch.tensor([r[i] for r in runs], dtype=torch.float32)
              for i in (1, 2, 3)), 8, n_iters)
    assert timing.routes(sp) == {'mmdma/cpu': n_iters}
    for b, (i, s, l1, l2) in enumerate(runs):
        R1, R2, rm = ref._mmdma_opt(jnp.asarray(Ks[0]), jnp.asarray(Ks[1]),
                                    jnp.asarray(a1[i]), jnp.asarray(a2[i]),
                                    s, l1, l2, 8, n_iters)
        for g, w in ((E1[b], R1), (E2[b], R2)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
        assert float(mmd[b]) == pytest.approx(float(rm), abs=1e-5)
