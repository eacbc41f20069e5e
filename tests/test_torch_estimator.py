"""JAMIE().fit_transform in both packages on the CPU, and checkpoints that
cross between them."""

import os

import numpy as np
import pytest
import scipy.sparse

from jamie_tpu import JAMIE as JaxJAMIE
from jamie_tpu_torch import JAMIE

# tests/test_end_to_end.py's FAST kwargs, with the default distance mode
# and PCA on (the port's main path)
FAST = dict(epoch_DNN=400, min_epochs=100, epoch_chunk=100, log_DNN=10_000,
            batch_size=64, pca_dim=(20, 10), distance_mode='geodesic',
            epoch_pd=300, use_early_stop=False, dropout=0.0)


@pytest.fixture(scope='module')
def fitted(synthetic_pair):
    data, labels = synthetic_pair
    jj = JaxJAMIE(use_mesh=False, **FAST)
    jax_out = jj.fit_transform(dataset=data)
    tj = JAMIE(device='cpu', **FAST)
    torch_out = tj.fit_transform(dataset=data)
    return jj, jax_out, tj, torch_out, data, labels


def test_correspondence_matches(fitted):
    """F is deterministic given the distances. Both solvers run bf16
    operands with f32 results (solver_dtype='bfloat16'), whose f32
    summation orders differ; over 300 iterations the drift is 1.3e-5 of
    F's max on this input, held at 1e-4, and the matched cell (row argmax)
    is the same."""
    jj, _, tj, _, _, _ = fitted
    ref = np.asarray(jj.match_result[0])
    ours = tj.match_result[0].cpu().numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * ref.max())
    assert np.mean(ours.argmax(1) == ref.argmax(1)) > 0.95


def test_integration_quality_in_the_same_band(fitted):
    jj, jax_out, tj, torch_out, _, labels = fitted
    f_ref, f_ours = jj.test_closer(jax_out), tj.test_closer(torch_out)
    lta_ref = jj.test_LabelTA(jax_out, labels)
    lta_ours = tj.test_LabelTA(torch_out, labels)
    assert f_ours < 0.15 and lta_ours > 0.8, (f_ours, lta_ours)
    # measured: FOSCTTM 0.0277 vs 0.0280, LTA 1.0 in both (different
    # sampling and noise streams, so a band rather than equality)
    assert abs(f_ours - f_ref) < 0.02 and abs(lta_ours - lta_ref) < 0.05
    assert torch_out[0].shape == jax_out[0].shape == (120, 32)
    keys, dist = tj.test_label_dist(torch_out, labels, verbose=False)
    assert list(keys) == ['a', 'b'] and dist.shape == (2, 2)
    assert dist[0, 0] == 0 and dist[0, 1] > 0


def test_serving_calls(fitted):
    _, _, tj, torch_out, data, _ = fitted
    re = tj.transform(data)
    np.testing.assert_allclose(re[0], torch_out[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tj.transform_one(data[1], 1), torch_out[1],
                               rtol=1e-5, atol=1e-5)
    assert tj.modal_predict(data[0], 0).shape == data[1].shape


@pytest.mark.parametrize('direction', ['jax_to_torch', 'torch_to_jax'])
def test_checkpoints_cross_load(fitted, tmp_path, direction):
    jj, _, tj, _, data, _ = fitted
    path = os.path.join(tmp_path, 'model.npz')
    src, dst = ((jj, JAMIE(device='cpu')) if direction == 'jax_to_torch'
                else (tj, JaxJAMIE(use_mesh=False)))
    src.save_model(path)
    dst.load_model(path)
    for m in (0, 1):
        np.testing.assert_allclose(dst.modal_predict(data[m], m),
                                   src.modal_predict(data[m], m),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dst.transform_one(data[m], m),
                                   src.transform_one(data[m], m),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('kwargs, item', [
    ({'project_mode': 'tsne'}, 12), ({'model_pca': 'umap'}, 12),
    ({'corr_method': 'jamie'}, 12), ({'compute_dtype': 'bfloat16'}, 13),
    ({'checkpoint_dir': 'ckpt'}, 13), ({'metrics_path': 'm.jsonl'}, 13),
    ({'mesh': object()}, 14),
])
def test_unported_options_raise(kwargs, item):
    """The options of items 12 (the t-SNE projection, the UMAP preclass,
    corr_method='jamie') and 13 (bf16 compute, mid-fit snapshots, the
    metrics log) are ported and build. A device mesh (item 14) is ported
    too (tests/test_torch_mesh.py): a mesh that is not a torch.distributed
    DeviceMesh raises TypeError."""
    if item in (12, 13):
        assert JAMIE(device='cpu', **kwargs).config.nondefault_kwargs() == kwargs
        return
    with pytest.raises(TypeError, match='DeviceMesh'):
        JAMIE(device='cpu', **kwargs)


def test_large_dataset_options_build():
    """corr_landmarks, the factor layouts and f_top_k are ported."""
    for kw in ({'corr_landmarks': 64}, {'f_top_k': 8},
               {'corr_landmarks': 32, 'corr_factor_layout': 'sparse'}):
        assert JAMIE(device='cpu', **kw).config.nondefault_kwargs() == kw


@pytest.mark.parametrize('rows', ['same', 'other'])
def test_refit_reuses_p_and_f_or_raises(synthetic_pair, rows):
    """A second fit_transform on one estimator keeps the first fit's P and
    F (self.P, self.match_result), as jamie_tpu does: with the same row
    counts it trains on them again (no new solve); with other row counts
    the port raises ValueError where jamie_tpu trains on the top-left
    block of the stale P and F (a deliberate deviation)."""
    data, _ = synthetic_pair
    kw = dict(SHORT, distance_mode='euclidean', epoch_pd=20)
    tj = JAMIE(device='cpu', **kw)
    first = tj.fit_transform(dataset=data)
    F, P = tj.match_result[0], tj.P
    jj = JaxJAMIE(use_mesh=False, **kw)
    jj.fit_transform(dataset=data)
    jF = jj.match_result[0]
    if rows == 'same':
        other = [d[::-1].copy() for d in data]
        again = tj.fit_transform(dataset=other)
        jj.fit_transform(dataset=other)
        assert tj.match_result[0] is F and tj.P is P
        assert jj.match_result[0] is jF
        assert again[0].shape == first[0].shape and np.isfinite(again[0]).all()
        return
    fewer = [d[:100] for d in data]
    with pytest.raises(ValueError, match='rows'):
        tj.fit_transform(dataset=fewer)
    out = jj.fit_transform(dataset=fewer)
    assert out[0].shape == (100, 32)


# ------------------------------------------------ the large-dataset route
# Short fits: the comparisons below are of what is deterministic given the
# inputs (the correspondence factors, the P/F forms, the sampling regime,
# final_corr), plus finite embeddings of the right shape.
SHORT = dict(epoch_DNN=12, min_epochs=4, batch_size=40, pca_dim=None,
             use_early_stop=False, dropout=0.0, log_DNN=10_000,
             log_pd=10_000, epoch_pd=150)


def _fit_both(data, P=None, patch=None, **kw):
    """The same fit in both packages; `patch` = {name: value} of estimator
    module globals, patched in both for the fit."""
    import jamie_tpu.estimator as jest
    import jamie_tpu_torch.estimator as test_
    saved = {k: (getattr(jest, k), getattr(test_, k)) for k in patch or {}}
    try:
        for k, v in (patch or {}).items():
            setattr(jest, k, v)
            setattr(test_, k, v)
        jj = JaxJAMIE(use_mesh=False, **kw)
        jout = jj.fit_transform(dataset=data, P=P)
        tj = JAMIE(device='cpu', **kw)
        tout = tj.fit_transform(dataset=data, P=P)
    finally:
        for k, (a, b) in saved.items():
            setattr(jest, k, a)
            setattr(test_, k, b)
    for e, n in zip(tout, (d.shape[0] for d in data)):
        assert e.shape == (n, kw.get('output_dim', 32)) and np.isfinite(e).all()
    return jj, jout, tj, tout


def _factors_match(ours, ref, tol):
    """Low-rank factors within `tol` of their largest entry."""
    assert type(ours).__name__ == type(ref).__name__
    assert ours.shape == ref.shape and ours.rank == ref.rank
    for a in ('u', 'v'):
        r = np.asarray(getattr(ref, a))
        np.testing.assert_allclose(getattr(ours, a).numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=a)


@pytest.fixture(scope='module')
def landmark_fitted(synthetic_pair):
    data, labels = synthetic_pair
    kw = {**FAST, 'corr_landmarks': 48, 'epoch_DNN': 200, 'min_epochs': 50}
    return (*_fit_both(data, **kw), data, labels)


def test_landmark_fit_matches_reference(landmark_fitted):
    """JAMIE(corr_landmarks=48) on the default geodesic mode: a rank-48
    LowRankF from FPS landmarks, no dense distances, the identity P. The
    factors agree within 2e-4 of their largest entry (bf16-operand solver
    matmuls with different f32 summation orders, as for the dense F,
    through the convex interpolation weights); quality lands in the same
    band (different sampling and noise streams)."""
    jj, jout, tj, tout, data, labels = landmark_fitted
    from jamie_tpu_torch.ops.lowrank import LowRankF, SparseLandmarkF
    F = tj.match_result[0]
    assert isinstance(F, LowRankF) and not isinstance(F, SparseLandmarkF)
    assert F.rank == 48 and tj.dist is None and jj.dist is None
    _factors_match(F, jj.match_result[0], 2e-4)
    assert tj.sampling_method == jj.sampling_method == 'diag'
    f_ref, f_ours = jj.test_closer(jout), tj.test_closer(tout)
    assert f_ours < 0.25 and abs(f_ours - f_ref) < 0.05, (f_ours, f_ref)
    np.testing.assert_allclose(tj.transform(data)[0], tout[0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tj.trainer.final_corr().numpy(),
                               np.asarray(jj.trainer.final_corr()),
                               rtol=0, atol=2e-4)


def test_landmark_auto_route_sparse_layout(synthetic_pair):
    """Past a patched LANDMARK_AUTO_ENTRIES the landmark route engages with
    no corr_landmarks (L = min(2048, N) = 120), here in the k-sparse
    layout: SparseLandmarkF factors within 1e-4 of their largest entry
    (euclidean mode, exact-f32 solver), identical landmark indices."""
    data, _ = synthetic_pair
    jj, _, tj, _ = _fit_both(
        data, patch={'LANDMARK_AUTO_ENTRIES': 1000}, distance_mode='euclidean',
        corr_factor_layout='sparse', solver_dtype='float32', **SHORT)
    from jamie_tpu_torch.ops.lowrank import SparseLandmarkF
    F, R = tj.match_result[0], jj.match_result[0]
    assert isinstance(F, SparseLandmarkF) and tj.dist is None
    for a in ('ix', 'iy'):
        np.testing.assert_array_equal(getattr(F, a).numpy(),
                                      np.asarray(getattr(R, a)))
    _factors_match(F, R, 1e-4)
    # P is a dense eye at this size, so final_corr densifies F either way
    np.testing.assert_allclose(tj.trainer.final_corr(100).numpy(),
                               np.asarray(jj.trainer.final_corr(100)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize('rows', ['equal', 'unequal'])
def test_sentinel_route(synthetic_pair, rows):
    """Past a patched SENTINEL_ENTRIES with use_f_tilde=False, P and F stay
    implicit as in jamie_tpu: F the 'zeros' sentinel, P the 'identity'
    sentinel (equal rows, 'diag') or a zero-nnz SparseRows (unequal rows,
    'zeros'); final_corr's sparse form matches exactly."""
    data, _ = synthetic_pair
    if rows == 'unequal':
        data = [data[0], data[1][:100]]
    jj, _, tj, _ = _fit_both(data, patch={'SENTINEL_ENTRIES': 1000},
                             use_f_tilde=False, **SHORT)
    assert tj.match_result == jj.match_result == ['zeros']
    assert tj.F == 'zeros'
    if rows == 'equal':
        assert tj.P == jj.P == 'identity'
    else:
        assert tj.P.nnz == jj.P.nnz == 0 and tj.P.shape == (120, 100)
    assert tj.sampling_method == jj.sampling_method == (
        'diag' if rows == 'equal' else 'zeros')
    np.testing.assert_array_equal(tj.trainer.final_corr(100).to_dense(),
                                  jj.trainer.final_corr(100).to_dense())


@pytest.mark.parametrize('prior', ['mask', 'scipy', 'mask_f_top_k'])
def test_partial_priors(synthetic_pair, prior):
    """A 1-D mask P, a scipy-sparse P and f_top_k, as README documents
    them: 'hybrid' sampling on the same matched pairs as jamie_tpu, the
    dense F within 1e-4 of its largest entry (euclidean, exact-f32
    solver) and, with f_top_k=4, the same top-k columns on at least 95% of
    the rows (neighbouring values may swap)."""
    data, _ = synthetic_pair
    mask = np.zeros(120, np.float32)
    mask[::2] = 1
    P = scipy.sparse.csr_matrix(np.diag(mask)) if prior == 'scipy' else mask
    kw = dict(distance_mode='euclidean', solver_dtype='float32', **SHORT)
    if prior == 'mask_f_top_k':
        kw['f_top_k'] = 4
    jj, _, tj, _ = _fit_both(data, P=P, **kw)
    assert tj.sampling_method == jj.sampling_method == 'hybrid'
    np.testing.assert_array_equal(tj.trainer._sampling_regime()[1],
                                  np.asarray(jj.trainer._pairs))
    ref = np.asarray(jj.match_result[0])
    np.testing.assert_allclose(tj.match_result[0].numpy(), ref, rtol=0,
                               atol=1e-4 * ref.max())
    if prior == 'mask_f_top_k':
        from jamie_tpu_torch.ops.sparse import SparseRows
        assert isinstance(tj.F, SparseRows) and tj.F.cols.shape == (120, 4)
        same = [set(a) == set(b) for a, b in zip(tj.F.cols, jj.F.cols)]
        assert np.mean(same) >= 0.95


def test_unported_inputs_raise(synthetic_pair):
    """Scipy-sparse modalities (item 11) and every distance mode (item 12)
    are ported: the cosine distance phase of a CSR pair gives its dense
    copy's matrices, which are jamie_tpu's within 1e-5."""
    import jamie_tpu.ops.distances as jd
    data, _ = synthetic_pair
    dists = []
    for d in ([scipy.sparse.csr_matrix(x) for x in data], data):
        jm = JAMIE(device='cpu', distance_mode='cosine')
        jm.dataset, jm.dataset_num = d, 2
        jm.compute_distances()
        dists.append([m.numpy() for m in jm.dist])
    for sparse_d, dense_d, x in zip(*dists, data):
        np.testing.assert_array_equal(sparse_d, dense_d)
        np.testing.assert_allclose(dense_d, np.asarray(
            jd.dataset_distance_matrix(x, 'cosine')), rtol=0, atol=1e-5)


# ------------------------------------------------ the nonlinear preclass
NLE = dict(epoch_DNN=20, min_epochs=5, batch_size=40, pca_dim=(6, 5),
           use_early_stop=False, dropout=0.0, log_DNN=10_000,
           distance_mode='euclidean', epoch_pd=50)


@pytest.mark.parametrize('method', ['umap', 'tsne'])
@pytest.mark.parametrize('direction', ['jax_to_torch', 'torch_to_jax'])
def test_nonlinear_preclass_checkpoints_cross_load(synthetic_pair, tmp_path,
                                                   method, direction):
    """A model_pca='umap'/'tsne' checkpoint saved by one package loads in
    the other (the nle_* keys): transform_one and modal_predict through the
    kNN interpolation agree within 1e-5."""
    data = [d[:60] for d in synthetic_pair[0]]
    kw = dict(NLE, model_pca=method)
    src = (JaxJAMIE(use_mesh=False, **kw) if direction == 'jax_to_torch'
           else JAMIE(device='cpu', **kw))
    src.fit_transform(dataset=data)
    path = os.path.join(tmp_path, 'model.npz')
    src.save_model(path)
    dst = (JAMIE(device='cpu') if direction == 'jax_to_torch'
           else JaxJAMIE(use_mesh=False))
    dst.load_model(path)
    for m in (0, 1):
        np.testing.assert_allclose(dst.transform_one(data[m], m),
                                   src.transform_one(data[m], m),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dst.modal_predict(data[m], m),
                                   src.modal_predict(data[m], m),
                                   rtol=1e-5, atol=1e-5)
