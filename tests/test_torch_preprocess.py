"""jamie_tpu_torch.preprocess against jamie_tpu.preprocess on the CPU."""

import numpy as np
import pytest
import scipy.sparse
import torch

from jamie_tpu import preprocess as jp
from jamie_tpu_torch import preprocess as tp


def _data(n, f, seed=0, rank=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, rank) @ rng.randn(rank, f) + 0.1 * rng.randn(n, f)
    return x.astype(np.float32) + 3.0


@pytest.mark.parametrize('nf', [(60, 90), (90, 40)])   # Gram / covariance
def test_direct_pca_matches_after_sign_fix(nf):
    # k below the data's rank 8, so every component has a clear eigengap
    # (components inside the noise floor rotate freely between libraries)
    x = _data(*nf)
    k = 6
    jmean, jcomps, _ = jp._pca_fit(x, k)
    tmean, tcomps = tp._pca_fit(torch.as_tensor(x), k)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-5)
    # f32 eigh in two libraries; components are unit vectors
    np.testing.assert_allclose(tcomps.numpy(), np.asarray(jcomps), atol=2e-4)


def _subspace_cosines(a, b):
    qa, _ = np.linalg.qr(a.T)
    qb, _ = np.linalg.qr(b.T)
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def test_randomized_pca_spans_the_same_subspace():
    """Omega comes from different generators, so compare what does not
    depend on it: the principal angles between the two component spans
    and the projection error of the data."""
    x = _data(300, 200, seed=1, rank=6)
    k = 6
    jmean, jcomps = jp._pca_fit_randomized(x, k)
    tmean, tcomps = tp._pca_fit_randomized(torch.as_tensor(x), k)
    jcomps, tcomps = np.asarray(jcomps), tcomps.numpy()
    assert _subspace_cosines(jcomps, tcomps).min() > 0.999
    xc = x - np.asarray(jmean)
    err = [np.linalg.norm(xc - xc @ c.T @ c) for c in (jcomps, tcomps)]
    assert abs(err[0] - err[1]) <= 1e-3 * err[0]


def test_pca_routing_threshold(monkeypatch):
    called = []
    monkeypatch.setattr(tp, '_RANDOMIZED_THRESHOLD', 50)
    orig = tp._pca_fit_randomized
    monkeypatch.setattr(tp, '_pca_fit_randomized',
                        lambda *a, **k: called.append(1) or orig(*a, **k))
    tp._pca_fit(torch.as_tensor(_data(80, 70)), 5)
    assert called


@pytest.mark.parametrize('pca_dim', [6, None])
def test_preprocessor_matches_and_round_trips(pca_dim):
    x = _data(70, 30, seed=2)
    jpre = jp.Preprocessor.fit(x, pca_dim=pca_dim)
    tpre = tp.Preprocessor.fit(x, pca_dim=pca_dim, device='cpu')
    jt, tt = np.asarray(jpre.transform_fit()), tpre.transform_fit()
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    np.testing.assert_allclose(tpre.transform(x), np.asarray(jpre.transform(x)),
                               atol=1e-4)
    back = tpre.inverse_transform(tt)
    np.testing.assert_allclose(back, np.asarray(jpre.inverse_transform(jt)),
                               atol=1e-3)
    if pca_dim is None:
        np.testing.assert_allclose(back, x, atol=1e-4)
    assert sorted(tpre.to_dict()) == sorted(jpre.to_dict())


def test_nan_maps_to_zero_as_reference():
    x = _data(40, 12, seed=4)
    x[3, 4] = np.nan
    jt = np.asarray(jp.Preprocessor.fit(x).transform(x))
    tt = tp.Preprocessor.fit(x, device='cpu').transform(x)
    assert not np.isnan(tt).any()
    np.testing.assert_allclose(tt, jt, atol=1e-5)


def test_preprocessor_from_dict_of_reference():
    x = _data(50, 30, seed=3)
    jpre = jp.Preprocessor.fit(x, pca_dim=8)
    d = {k: np.asarray(v) for k, v in jpre.to_dict().items()}
    tpre = tp.Preprocessor.from_dict(d, device='cpu')
    np.testing.assert_allclose(tpre.transform(x), np.asarray(jpre.transform(x)),
                               atol=1e-4)


def test_pca_dim_clamped_with_warning():
    with pytest.warns(UserWarning, match='PCA dim'):
        pre = tp.Preprocessor.fit(_data(20, 10), pca_dim=50, device='cpu')
    assert pre.transform_fit().shape == (20, 10)


def test_unported_preprocessing_raises():
    """The t-SNE/UMAP preclass is ported (item 12): it fits a
    NonlinearEmbedding with jamie_tpu's checkpoint keys; a scipy-sparse
    input, ported with item 11, fits as its dense copy does."""
    pre = tp.Preprocessor.fit(_data(20, 10), pca_dim=5, method='umap',
                              device='cpu')
    assert isinstance(pre.pca, tp.NonlinearEmbedding)
    assert pre.transform_fit().shape == (20, 5)
    assert sorted(pre.to_dict()) == sorted(jp.Preprocessor.fit(
        _data(20, 10), pca_dim=5, method='umap').to_dict())
    x = _data(20, 10)
    pre = tp.Preprocessor.fit(scipy.sparse.csr_matrix(x), pca_dim=5,
                              device='cpu')
    np.testing.assert_allclose(
        pre.transform_fit(),
        tp.Preprocessor.fit(x, pca_dim=5, device='cpu').transform_fit(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('direction', ['forward', 'inverse'])
def test_knn_interpolate_matches_reference(direction):
    """NonlinearEmbedding's transform / inverse_transform with an injected
    fit_data_ and embedding_: the same 10 neighbours (tie-free data) and
    weights, within 1e-5 of the largest value; an exact fit row returns
    its own value."""
    rng = np.random.RandomState(5)
    fit, emb = _data(50, 12, seed=6), rng.randn(50, 3).astype(np.float32)
    ref, ours = jp.NonlinearEmbedding(3), tp.NonlinearEmbedding(3,
                                                                device='cpu')
    for nle in (ref, ours):
        nle.fit_data_, nle.embedding_ = fit, emb
    if direction == 'forward':
        q = np.vstack([fit[:3], _data(17, 12, seed=7)])
        r, o = np.asarray(ref.transform(q)), ours.transform(q)
        np.testing.assert_allclose(o[:3], emb[:3], atol=1e-5)
    else:
        q = rng.randn(20, 3).astype(np.float32)
        r, o = np.asarray(ref.inverse_transform(q)), ours.inverse_transform(q)
    np.testing.assert_allclose(o, r, rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize('method', ['umap', 'tsne'])
def test_nonlinear_preclass_round_trips_through_dict(method):
    """to_dict -> from_dict keeps the fit data, embedding and method, so
    transform is unchanged; a jamie_tpu dict loads the same way."""
    x = _data(40, 10, seed=8)
    pre = tp.Preprocessor.fit(x, pca_dim=3, method=method, device='cpu')
    back = tp.Preprocessor.from_dict(
        {k: np.asarray(v) for k, v in pre.to_dict().items()}, device='cpu')
    assert back.pca.method == method
    np.testing.assert_array_equal(back.transform(x), pre.transform(x))
    jpre = jp.Preprocessor.fit(x, pca_dim=3, method=method)
    tpre = tp.Preprocessor.from_dict(
        {k: np.asarray(v) for k, v in jpre.to_dict().items()}, device='cpu')
    np.testing.assert_allclose(tpre.transform(x), np.asarray(jpre.transform(x)),
                               rtol=1e-5, atol=1e-5)


def test_pca_null_component_is_zero_not_amplified():
    """pca_dim at or above the cell count (JAMIE's default 512 on the
    MMD-MA sim shape's 300 cells: clamped to 300): the 300 centred rows
    span 299 directions, and the Gram route's 300th component is the null
    space; with each of the first 150 rows repeated, they span 149, and
    the null space is the last 151. The port zeroes it, so each modality's
    standardized fit sample is the float64 SVD's (centred scores U S,
    scalar-standardized, the columns past the rank 0): its column norms
    (the singular values) within 1e-2 relative, and the 32 leading
    columns (the latent rank, clear eigengaps; the noise floor's
    components rotate freely between libraries) within 1e-3 of the
    largest entry, up to sign. Kept, S^-1 U^T Xc amplified the null
    components' rounding into columns carrying most of the standardized
    variance (the port did so on the 2000-feature modality, jamie_tpu on
    the 1000-feature one). A genuine small component is kept."""
    from jamie_tpu_torch.synth import synthesize
    for x in synthesize((300, 2000), (300, 1000), cache=False):
        x = np.asarray(x)
        for data, rank in ((x, 299), (np.concatenate([x[:150]] * 2), 149)):
            with pytest.warns(UserWarning, match='PCA dim'):
                pre = tp.Preprocessor.fit(data, pca_dim=512, device='cpu')
            got = np.asarray(pre.transform_fit(), np.float64)
            assert got.shape == (300, 300)
            # zero scores, shifted only by the scalar standardization's mean
            assert np.ptp(got[:, rank:]) == 0.0 and abs(got[0, 299]) < 1e-6
            xc = np.asarray(data, np.float64)
            xc = xc - xc.mean(0)
            u, s, _ = np.linalg.svd(xc, full_matrices=False)
            ref = u * s
            ref[:, rank:] = 0.0
            ref = (ref - ref.mean()) / ref.std()
            norms = [np.linalg.norm(a[:, :rank] - a[0, 299], axis=0)
                     for a in (got, ref)]
            np.testing.assert_allclose(norms[0], norms[1], rtol=1e-2)
            top = got[:, :32] * np.sign((got[:, :32] * ref[:, :32]).sum(0))
            np.testing.assert_allclose(top, ref[:, :32], rtol=0,
                                       atol=1e-3 * np.abs(ref).max())
    # a spectrum falling to 43 eps of its top (SNARE-like RNA at PCA-512):
    # every component is genuine and kept
    from jamie_tpu_torch.synth import make_snare_like
    rna = make_snare_like()[0][0]
    got = np.asarray(tp.Preprocessor.fit(rna, pca_dim=512,
                                         device='cpu').transform_fit())
    assert got.shape == (1047, 512) and np.ptp(got, axis=0).min() > 0.0
