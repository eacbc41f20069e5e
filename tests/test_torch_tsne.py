"""jamie_tpu_torch.solvers.tsne and the project_mode='tsne' fit against
jamie_tpu on the CPU. The port's squared embedding distances come from K3's
plain version (the Gram form) where jamie_tpu takes an exact broadcast;
the same initial embeddings are injected into both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jamie_tpu import JAMIE as JaxJAMIE
from jamie_tpu.ops.distances import pairwise_distance as jax_distance
from jamie_tpu.solvers import tsne as jt
from jamie_tpu_torch import JAMIE
from jamie_tpu_torch.solvers import tsne as tt


def _clusters(n=60, seed=1):
    """tests/test_tsne.py's two-cluster pair of modalities."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, n)
    x = (np.array([[0.0] * 5, [8.0] * 5])[labels]
         + 0.3 * rng.randn(n, 5)).astype(np.float32)
    y = (x[:, :4] + 0.1 * rng.randn(n, 4)).astype(np.float32)
    return x, y, labels


@pytest.fixture(scope='module')
def joint():
    x, y, labels = _clusters()
    dists = [np.asarray(jax_distance(a)) for a in (x, y)]
    P_ref = [np.asarray(jt.joint_probabilities(d, 15)) for d in dists]
    return dists, P_ref, labels


def test_calibrate_beta_matches_reference(joint):
    """The conditional P of 50 fixed bisection steps, within 1e-6 of its
    largest entry (float32 exp and sums in two libraries; measured 4e-7)."""
    D = joint[0][0] ** 2
    ref = np.asarray(jt._calibrate_beta(jnp.asarray(D), 15.0))
    ours = tt._calibrate_beta(torch.as_tensor(D), 15.0).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * ref.max())
    np.testing.assert_allclose(ours.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize('source', ['host', 'tensor'])
def test_joint_probabilities_match_reference(joint, source):
    """Within 1e-5 of the largest entry (measured 3e-7), from a host array
    or a tensor; a tensor comes back, symmetric, summing to 1."""
    dists, P_ref, _ = joint
    for d, ref in zip(dists, P_ref):
        src = torch.as_tensor(d) if source == 'tensor' else d
        ours = tt.joint_probabilities(src, 15, device='cpu')
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.float32
        ours = ours.numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * ref.max())
        np.testing.assert_allclose(ours, ours.T, atol=1e-9)
        np.testing.assert_allclose(ours.sum(), 1.0, rtol=1e-5)
        assert np.diag(ours).max() < 1e-6


def _init(n, dim, seed):
    rng = np.random.RandomState(seed)
    return [(1e-4 * rng.randn(n, dim)).astype(np.float32) for _ in range(2)]


def test_tsne_optimize_matches_reference(joint):
    """40 Adam steps of the paired t-SNE (the exaggeration annealed over 20
    of them, permuted pairs) from the same initial embeddings: within 1e-4
    of the largest coordinate (measured 1.1e-6; the two distance forms
    round differently, and t-SNE amplifies rounding over hundreds of
    steps, so the test stays short)."""
    _, (P1, P2), _ = joint
    n = P1.shape[0]
    Y1, Y2 = _init(n, 2, 0)
    perm = np.random.RandomState(3).permutation(n)
    kw = dict(exaggeration_iters=20, lr=0.5, exaggeration=12.0)
    ref = jt._tsne_optimize(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(Y1),
                            jnp.asarray(Y2), jnp.asarray(np.arange(n)),
                            jnp.asarray(perm), 10.0, 40, **kw)
    ours = tt._tsne_optimize(torch.as_tensor(P1), torch.as_tensor(P2),
                             torch.as_tensor(Y1), torch.as_tensor(Y2),
                             np.arange(n), perm, 10.0, 40, **kw)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_tsne_single_and_embed_match_reference(joint):
    """The single-dataset loop (hard 12x exaggeration for 20 of 40 steps)
    within 1e-4 of the largest coordinate (measured 1.3e-6). tsne_embed
    with an injected init is exactly the port's distances -> joint
    probabilities -> loop, and within 1e-2 of jamie_tpu's pipeline over 10
    steps (measured 2.1e-3): the two packages' Gram-form euclidean
    distances round differently on close pairs (1.4e-4 apart here), which
    moves P by 3e-4 of its largest entry before the loop amplifies it."""
    from jamie_tpu_torch.ops.distances import pairwise_distance
    x, _, _ = _clusters()
    P = joint[1][0]
    Y0 = _init(P.shape[0], 3, 1)[0]
    ref = np.asarray(jt._tsne_single(jnp.asarray(P), jnp.asarray(Y0), 40,
                                     exaggeration_iters=20))
    ours = tt._tsne_single(torch.as_tensor(P), torch.as_tensor(Y0), 40,
                           exaggeration_iters=20).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    emb = tt.tsne_embed(x, 3, perplexity=15, n_iters=10, init=Y0,
                        device='cpu')
    assert isinstance(emb, np.ndarray) and emb.shape == (60, 3)
    own = tt._tsne_single(tt.joint_probabilities(
        pairwise_distance(x, device='cpu'), 15, device='cpu'),
        torch.as_tensor(Y0), 10).numpy()
    np.testing.assert_array_equal(emb, own)
    ref = np.asarray(jt._tsne_single(
        jnp.asarray(jt.joint_probabilities(np.asarray(jax_distance(x)), 15)),
        jnp.asarray(Y0), 10))
    np.testing.assert_allclose(emb, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def test_project_tsne_seeded_and_separates_clusters(joint):
    """tests/test_tsne.py's cluster test through the port: the seeded init
    is reproducible, clusters separate and matched pairs land closer than
    a random permutation."""
    _, (P1, P2), labels = joint
    n = P1.shape[0]
    pairs = np.arange(n)
    Y1, Y2 = tt.project_tsne(None, [P1, P2], pairs, pairs, output_dim=2,
                             n_iters=400, device='cpu')
    again = tt.project_tsne(None, [P1, P2], pairs, pairs, output_dim=2,
                            n_iters=400, device='cpu')
    np.testing.assert_array_equal(Y1, again[0])
    assert np.isfinite(Y1).all() and np.isfinite(Y2).all()
    d_intra = np.linalg.norm(Y1[labels == 0] - Y1[labels == 0].mean(0),
                             axis=1).mean()
    d_inter = np.linalg.norm(Y1[labels == 0].mean(0) - Y1[labels == 1].mean(0))
    assert d_inter > 2 * d_intra
    rng = np.random.RandomState(0)
    d_match = np.linalg.norm(Y1 - Y2, axis=1).mean()
    assert d_match < np.linalg.norm(Y1 - Y2[rng.permutation(n)], axis=1).mean()


def _tsne_inputs(seed, n, dims):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, dims[0]).astype(np.float32)
    return [(z @ rng.randn(dims[0], f)).astype(np.float32) for f in dims[1:]]


@pytest.mark.parametrize('case', ['dense', 'zeros_sentinel'])
def test_estimator_tsne_fit_matches_reference(case, monkeypatch):
    """tests/test_tsne.py's two estimator fits through both packages: F
    within the prime-dual tolerance (1e-4 of its largest entry, bf16
    operands in both), the same Hungarian pairs (or the synthesized
    leading diagonal past a patched SENTINEL_ENTRIES), joint probabilities
    within 1e-5 of their largest entry, and FOSCTTM within 0.1 (the
    initial embeddings come from different generators)."""
    import jamie_tpu.estimator as jest
    import jamie_tpu_torch.estimator as test_
    if case == 'dense':
        data = _tsne_inputs(2, 50, (4, 20, 15))
        kw = dict(project_mode='tsne', output_dim=2, epoch_pd=200,
                  distance_mode='euclidean', perplexity=10)
    else:
        for mod in (jest, test_):
            monkeypatch.setattr(mod, 'SENTINEL_ENTRIES', 100)  # 40*40 > 100
        data = _tsne_inputs(3, 40, (3, 12, 9))
        kw = dict(project_mode='tsne', output_dim=2, use_f_tilde=False,
                  distance_mode='euclidean', perplexity=10)
    jj = JaxJAMIE(use_mesh=False, **kw)
    jout = jj.fit_transform(dataset=data)
    tj = JAMIE(device='cpu', **kw)
    tout = tj.fit_transform(dataset=data)
    n = data[0].shape[0]
    for e in tout:
        assert e.shape == (n, 2) and np.isfinite(e).all()
    assert not hasattr(tj, 'phase_timings')
    if case == 'dense':
        ref = np.asarray(jj.match_result[0])
        np.testing.assert_allclose(tj.match_result[0].numpy(), ref, rtol=0,
                                   atol=1e-4 * ref.max())
    else:
        assert tj.match_result == jj.match_result == ['zeros']
    np.testing.assert_array_equal(tj.pairs_x[0], jj.pairs_x[0])
    np.testing.assert_array_equal(tj.pairs_y[0], jj.pairs_y[0])
    for i in range(2):
        ref = np.asarray(jt.joint_probabilities(jj.dist[i], 10))
        ours = tt.joint_probabilities(tj.dist[i], 10, device='cpu').numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * ref.max())
    f_ref, f_ours = jj.test_closer(jout), tj.test_closer(tout)
    assert abs(f_ours - f_ref) < 0.1, (f_ours, f_ref)


@pytest.mark.parametrize('window,iters', [(0, 6), (7, 12), (40, 12)])
def test_device_counter_exaggeration_matches_reference(joint, window, iters):
    """The exaggeration computed from the device step counter: annealed
    (`_tsne_optimize`) and hard-switched (`_tsne_single`) with the window
    empty, ending inside the run and past it, against jamie_tpu's
    fori_loops from the same initial embeddings at
    test_tsne_optimize_matches_reference's tolerance (1e-4 of the
    largest coordinate)."""
    _, (P1, P2), _ = joint
    n = P1.shape[0]
    Y1, Y2 = _init(n, 2, 5)
    perm = np.random.RandomState(4).permutation(n)
    ref = jt._tsne_optimize(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(Y1),
                            jnp.asarray(Y2), jnp.asarray(np.arange(n)),
                            jnp.asarray(perm), 10.0, iters,
                            exaggeration_iters=window, exaggeration=6.0)
    ours = tt._tsne_optimize(torch.as_tensor(P1), torch.as_tensor(P2),
                             torch.as_tensor(Y1), torch.as_tensor(Y2),
                             np.arange(n), perm, 10.0, iters,
                             exaggeration_iters=window, exaggeration=6.0)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
    ref = np.asarray(jt._tsne_single(jnp.asarray(P1), jnp.asarray(Y1), iters,
                                     exaggeration_iters=window))
    ours = tt._tsne_single(torch.as_tensor(P1), torch.as_tensor(Y1), iters,
                           exaggeration_iters=window).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize('tol_iters', [1, 7])
def test_calibrate_beta_step_count_matches_reference(joint, tol_iters):
    """The bisection step replayed tol_iters times (the graph's replay
    count on the card) against jamie_tpu's fori_loop of as many steps, at
    test_calibrate_beta_matches_reference's 1e-6 of the largest entry."""
    D = joint[0][1] ** 2
    ref = np.asarray(jt._calibrate_beta(jnp.asarray(D), 15.0,
                                        tol_iters=tol_iters))
    ours = tt._calibrate_beta(torch.as_tensor(D), 15.0,
                              tol_iters=tol_iters).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * ref.max())
