"""scipy-sparse data matrices through the port's distances, PCA, landmark
correspondence and estimator, against jamie_tpu on the same inputs (and
tests/test_sparse_data_input.py's fixtures), with every large-matrix
route forced by patching its threshold in both packages.

Tolerances: routes that round to bf16 and accumulate in f32 agree with
jamie_tpu's to f32 summation order of the norm scale (1e-5 of
2 max|x|^2 on squared distances); randomized PCA sketches draw Omega from
different generators, so PCA is held by the subspace cosines of the
leading components and by the per-component correlation of the scores."""

import numpy as np
import pytest
from scipy import sparse
import torch

from jamie_tpu import preprocess as jp
from jamie_tpu.core import residency as jr
from jamie_tpu.ops import distances as jd
from jamie_tpu.solvers import landmark as jl
from jamie_tpu_torch import preprocess as tp
from jamie_tpu_torch.core import hostmat
from jamie_tpu_torch.core import residency as tr
from jamie_tpu_torch.core import timing
from jamie_tpu_torch.ops import distances as td
from jamie_tpu_torch.solvers import landmark as tl


def _sparse_pair(n=40, f=25, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.rand(n, f).astype(np.float32)
    dense[rng.rand(n, f) > density] = 0.0
    return dense, sparse.csr_matrix(dense)


def _np(d):
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


@pytest.fixture(autouse=True)
def _fresh():
    for m in (tr, jr):
        m.clear_residency_cache()
    yield
    for m in (tr, jr):
        m.clear_residency_cache()


def _routes(fn, *a, **k):
    """fn(*a, **k) inside a span: its output and the routes it took."""
    with timing.span('call') as call:
        out = fn(*a, **k)
    return out, timing.routes(call)


def _patched(monkeypatch, **values):
    """Set each module global of that name, for the rest of the test, in
    whichever of the two packages' modules define it."""
    mods = (tr, jr, td, jd, tp, jp, tl, jl)
    for name, v in values.items():
        hit = [m for m in mods if hasattr(m, name)]
        assert hit, name
        for m in hit:
            monkeypatch.setattr(m, name, v)


def _subspace_cosines(a, b):
    qa, _ = np.linalg.qr(np.asarray(a, np.float64).T)
    qb, _ = np.linalg.qr(np.asarray(b, np.float64).T)
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def test_hostmat_helpers():
    dense, csr = _sparse_pair()
    assert hostmat.is_scipy_sparse(csr) and not hostmat.is_scipy_sparse(dense)
    assert hostmat.ensure_row_major(csr) is csr
    assert hostmat.ensure_row_major(csr.tocsc()).format == 'csr'
    assert hostmat.ensure_col_major(csr).format == 'csc'
    assert hostmat.ensure_col_major(dense) is dense
    np.testing.assert_array_equal(hostmat.densify(csr), dense)
    np.testing.assert_array_equal(hostmat.dense_rows(csr, 5, 12),
                                  dense[5:12])
    np.testing.assert_array_equal(
        hostmat.dense_cols(hostmat.ensure_col_major(csr), 3, 9),
        dense[:, 3:9])
    assert hostmat.as_f32_ndarray(dense) is dense


@pytest.mark.parametrize('mode', ['euclidean', 'sqeuclidean', 'geodesic'])
def test_distance_modes_sparse_parity(mode):
    """Under the threshold a CSR source is densified and goes through K3's
    route: the same matrix as the dense source, and as jamie_tpu's."""
    dense, csr = _sparse_pair()
    ours = _np(td.dataset_distance_matrix(csr, mode, device='cpu'))
    np.testing.assert_array_equal(
        ours, _np(td.dataset_distance_matrix(dense, mode, device='cpu')))
    ref = np.asarray(jd.dataset_distance_matrix(csr, mode))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('route', ['resident', 'chunked'])
@pytest.mark.parametrize('squared', [False, True])
def test_large_distance_routes(monkeypatch, route, squared):
    """Past _FEATURE_CHUNK_THRESHOLD (patched) a self distance takes the bf16
    residency, or with no budget the feature-chunked Gram (three chunks
    here): sparse and dense sources give identical matrices, within f32
    summation order of jamie_tpu's, symmetric with a zero diagonal."""
    dense, csr = _sparse_pair(n=32, f=3000, density=0.05)
    # at real sizes the threshold implies the uploader's bf16 rounding
    kw = {'_FEATURE_CHUNK_THRESHOLD': 100, 'BF16_LINK_ELEMS': 100}
    if route == 'chunked':
        kw['DEFAULT_BUDGET_BYTES'] = 0
    metric = 'sqeuclidean' if squared else 'euclidean'
    _patched(monkeypatch, **kw)
    chunk = 32 * 4 * 1024        # 1024 features a chunk
    if route == 'chunked':
        orig = td._pairwise_euclidean_feature_chunked
        monkeypatch.setattr(
            td, '_pairwise_euclidean_feature_chunked',
            lambda *a: orig(*a, chunk_bytes=chunk))
    d_dense, first = _routes(td.pairwise_distance, dense, metric,
                             device='cpu')
    d_dense = _np(d_dense)
    tr.clear_residency_cache()
    d_sparse, second = _routes(td.pairwise_distance, csr, metric,
                               device='cpu')
    d_sparse = _np(d_sparse)
    ref = np.asarray(jd.pairwise_distance(csr, metric))
    name = ('distance_resident_bf16' if route == 'resident'
            else 'distance_feature_chunked')
    assert (first + second)[name] == 2
    np.testing.assert_array_equal(d_sparse, d_dense)
    assert (np.diag(d_sparse) == 0).all()
    scale = 2 * float((dense.astype(np.float64) ** 2).sum(1).max())
    sq = (lambda d: d) if squared else (lambda d: d.astype(np.float64) ** 2)
    assert np.abs(sq(d_sparse) - sq(ref)).max() <= 1e-5 * scale
    assert np.abs(sq(d_sparse) - sq(d_sparse).T).max() <= 1e-5 * scale
    # and the bf16-rounded data in float64
    xb = torch.as_tensor(dense).bfloat16().double().numpy()
    g = xb @ xb.T
    d2 = np.maximum(np.diag(g)[:, None] + np.diag(g)[None] - 2 * g, 0)
    np.fill_diagonal(d2, 0)
    assert np.abs(sq(d_sparse) - d2).max() <= 1e-5 * scale


def test_cross_distance_takes_the_chunked_route(monkeypatch):
    """A cross distance past the threshold never takes the residency; a
    tensor operand is sliced where it lies."""
    rng = np.random.RandomState(2)
    xh = rng.randn(40, 30).astype(np.float32)
    yh = rng.randn(25, 30).astype(np.float32)
    _patched(monkeypatch, _FEATURE_CHUNK_THRESHOLD=100)
    d, routes = _routes(td._pairwise_euclidean_impl, torch.as_tensor(xh),
                        yh, squared=True, device='cpu')
    d = d.numpy()
    ref = np.asarray(jd.pairwise_sq_euclidean(xh, yh))
    assert routes['distance_feature_chunked'] == 1
    np.testing.assert_allclose(d, ref, rtol=0, atol=1e-5 * 2 * float(
        (xh ** 2).sum(1).max() + (yh ** 2).sum(1).max()))


def test_pca_sparse_direct_and_transform():
    """Under the threshold a CSR PCA densifies: the same scores as the dense
    source, and as jamie_tpu's."""
    dense, csr = _sparse_pair(n=30, f=50, density=0.4)
    out_d = tp.PCA(5, device='cpu').fit_transform(dense)
    out_s = tp.PCA(5, device='cpu').fit_transform(csr)
    np.testing.assert_allclose(out_s, out_d, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_s, np.asarray(jp.PCA(5).fit_transform(csr)),
                               rtol=1e-3, atol=1e-4)
    pca = tp.PCA(5, device='cpu').fit(dense)
    np.testing.assert_allclose(pca.transform(csr), pca.transform(dense),
                               rtol=1e-5, atol=1e-5)


def _tall(n=400, f=40, seed=11):
    """Strongly separated spectrum: near-degenerate eigenpairs would rotate
    freely between the exact and randomized routes."""
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 6).astype(np.float32) * np.array(
        [16, 9, 5.5, 3.2, 1.9, 1.0], np.float32)
    return np.maximum(z @ rng.randn(6, f) - 0.3, 0).astype(np.float32)


@pytest.mark.parametrize('route', ['resident', 'row_streamed',
                                   'row_streamed_blocks'])
@pytest.mark.parametrize('source', ['dense', 'csr'])
def test_pca_tall_routes(monkeypatch, route, source):
    """Past _STREAM_THRESHOLD (patched) a tall matrix takes the bf16
    residency, or with no budget the row-streamed route (a CSR source by
    SpMM on its DeviceCSR, in more than one _SKETCH_SPMM_ROWS block for
    'row_streamed_blocks'). Held to jamie_tpu's same route and to the exact
    fit: the five components' subspace cosines > 0.999 and each score
    column's correlation > 0.999; the scores come back as a device tensor
    that reproduces the projection of the data."""
    X = _tall()
    src = X if source == 'dense' else sparse.csr_matrix(X)
    kw = {'_STREAM_THRESHOLD': 100}
    if route != 'resident':
        kw['DEFAULT_BUDGET_BYTES'] = 0
    if route == 'row_streamed_blocks':
        kw['_SKETCH_SPMM_ROWS'] = 128
    exact = tp.PCA(5, device='cpu').fit_transform(X)
    _patched(monkeypatch, **kw)
    pca = tp.PCA(5, device='cpu')
    out, routes = _routes(pca.fit_transform, src)
    ref = jp.PCA(5)
    ref_out = np.asarray(ref.fit_transform(src))
    name = 'pca_resident_bf16' if route == 'resident' else 'pca_row_streamed'
    assert routes[name] == 1
    assert isinstance(out, torch.Tensor) and out.shape == (400, 5)
    out = out.numpy()
    comps = pca.components_.numpy()
    assert _subspace_cosines(comps, np.asarray(ref.components_)).min() > 0.999
    for other in (ref_out, exact):
        for j in range(5):
            assert np.corrcoef(out[:, j], other[:, j])[0, 1] > 0.999
    np.testing.assert_allclose(np.linalg.norm(out, axis=0),
                               np.linalg.norm(exact, axis=0), rtol=1e-2)


@pytest.mark.parametrize('power_iters', [0, 1, 3])
def test_pca_resident_route_takes_power_iters(monkeypatch, power_iters):
    """`power_iters` reaches the bf16-resident route (jamie_tpu's runs one
    whatever it is): one bf16 sketch product, then one more an iteration;
    on a slowly decaying spectrum the iterations bring the subspace to
    the exact fit's, past what one sketch finds."""
    rng = np.random.RandomState(3)
    z = rng.randn(600, 5) * np.array([6, 5, 4, 3.5, 3])
    X = (z @ rng.randn(5, 120) / np.sqrt(5)
         + rng.randn(600, 120)).astype(np.float32)
    exact = tp.PCA(5, device='cpu').fit(X)
    _patched(monkeypatch, _STREAM_THRESHOLD=100)
    calls = []
    product = tp.bf16_matmul
    monkeypatch.setattr(tp, 'bf16_matmul',
                        lambda a, b: calls.append(1) or product(a, b))
    ours, routes = _routes(
        tp.PCA(5, device='cpu', power_iters=power_iters).fit, X)
    assert routes['pca_resident_bf16'] == 1
    assert len(calls) == power_iters + 1
    sine = np.sqrt(1 - _subspace_cosines(
        ours.components_.numpy(), exact.components_.numpy()).min() ** 2)
    assert (sine > 1e-2) if power_iters == 0 else (sine < 1e-3)


@pytest.mark.parametrize('source', ['dense', 'csr'])
def test_pca_wide_streamed_route(monkeypatch, source):
    """A wide matrix past the threshold with no budget streams column
    chunks (CSC for a sparse source): the leading components span the same
    space as jamie_tpu's and the exact fit's (cosines > 0.999 on the three
    strong directions)."""
    rng = np.random.RandomState(4)
    z = rng.randn(60, 5).astype(np.float32) * np.array([20, 12, 7, 1, 0.5],
                                                       np.float32)
    X = np.maximum(z @ rng.randn(5, 3000) - 0.3, 0).astype(np.float32)
    src = X if source == 'dense' else sparse.csr_matrix(X)
    exact = tp.PCA(5, device='cpu').fit(X)
    _patched(monkeypatch, _STREAM_THRESHOLD=100, DEFAULT_BUDGET_BYTES=0)
    ours = tp.PCA(5, device='cpu')
    out, routes = _routes(ours.fit_transform, src)
    ref = jp.PCA(5)
    ref.fit(src)
    assert routes['pca_streamed'] == 1
    assert out.shape == (60, 5)
    c = ours.components_.numpy()[:3]
    assert _subspace_cosines(c, np.asarray(ref.components_)[:3]).min() > 0.999
    assert _subspace_cosines(c, exact.components_.numpy()[:3]).min() > 0.999


def test_pca_wide_resident_csr_takes_the_spmm_route(monkeypatch):
    """A wide CSR past the threshold whose dense bf16 copy is over the
    budget but whose DeviceCSR fits runs the row-streamed route's SpMMs
    on the resident CSR (jamie_tpu streams its columns through a host
    CSC): the leading components and scores agree with the exact fit."""
    rng = np.random.RandomState(4)
    z = rng.randn(60, 5).astype(np.float32) * np.array([20, 12, 7, 1, 0.5],
                                                       np.float32)
    X = np.maximum(z @ rng.randn(5, 3000) - 8.0, 0).astype(np.float32)
    src = sparse.csr_matrix(X)
    dense_bf16, csr = 2 * X.size, 4 * src.nnz + 4 * 61
    assert csr < dense_bf16
    exact = tp.PCA(5, device='cpu').fit(X)
    _patched(monkeypatch, _STREAM_THRESHOLD=100,
             DEFAULT_BUDGET_BYTES=(csr + dense_bf16) // 2)
    ours = tp.PCA(5, device='cpu')
    out, routes = _routes(ours.fit_transform, src)
    assert routes['pca_row_streamed'] == 1
    assert routes['pca_streamed'] == 0
    assert isinstance(out, torch.Tensor) and out.shape == (60, 5)
    c = ours.components_.numpy()[:3]
    assert _subspace_cosines(c, exact.components_.numpy()[:3]).min() > 0.999
    want = exact.transform(X)
    for j in range(3):
        assert abs(np.corrcoef(out.numpy()[:, j], want[:, j])[0, 1]) > 0.999


def test_pca_transform_spmm_route(monkeypatch):
    """From _STREAM_THRESHOLD elements (patched, `>=`) PCA.transform of a
    resident CSR projects by SpMM (bf16-rounded components at the patched
    BF16_LINK_ELEMS): within bf16 operand rounding of the dense projection
    and of jamie_tpu's same route."""
    rng = np.random.RandomState(8)
    n, f, k = 300, 80, 6
    base = rng.randn(n, 8) @ rng.randn(8, f)
    base[rng.rand(n, f) < 0.6] = 0.0
    base = torch.as_tensor(base.astype(np.float32)).bfloat16().float().numpy()
    ours = tp.PCA(k, device='cpu').fit(base)
    ref = jp.PCA(k).fit(base)
    dense_out = ours.transform(base)
    csr = sparse.csr_matrix(base)
    _patched(monkeypatch, _STREAM_THRESHOLD=n * f, BF16_LINK_ELEMS=100)
    out, routes = _routes(ours.transform, csr, row_chunk_bytes=f * 4 * 64)
    ref_out = ref.transform(csr, row_chunk_bytes=f * 4 * 64)
    assert routes['pca_transform_spmm'] == 1
    np.testing.assert_allclose(out, dense_out, rtol=5e-2, atol=2e-2)
    np.testing.assert_allclose(out, ref_out, rtol=5e-2, atol=2e-2)


def test_preprocessor_sparse_without_pca_densifies():
    dense, csr = _sparse_pair()
    pre_d = tp.Preprocessor.fit(dense, device='cpu')
    pre_s = tp.Preprocessor.fit(csr, device='cpu')
    ref = jp.Preprocessor.fit(csr)
    np.testing.assert_array_equal(pre_s.transform_fit(), pre_d.transform_fit())
    np.testing.assert_allclose(pre_s.transform_fit(),
                               np.asarray(ref.transform_fit()), atol=1e-5)
    np.testing.assert_array_equal(pre_s.transform(csr), pre_d.transform(dense))
    np.testing.assert_allclose(pre_s.transform(csr),
                               np.asarray(ref.transform(csr)), atol=1e-5)


def test_transform_fit_device_path_is_one_shot(monkeypatch):
    """A large-route fit sample (a device tensor) is standardized on the
    device, in place, once; the statistics match the host path's."""
    X = _tall()
    _patched(monkeypatch, _STREAM_THRESHOLD=100)
    pre = tp.Preprocessor.fit(X, pca_dim=4, device='cpu')
    sample = pre._fit_sample
    assert isinstance(sample, torch.Tensor)
    raw = sample.numpy().copy()
    np.testing.assert_allclose(pre.sample_mean, raw.mean(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pre.sample_std, raw.std(), rtol=1e-4)
    out = pre.transform_fit()
    assert isinstance(out, torch.Tensor) and pre.pca.scores_ is None
    np.testing.assert_allclose(out.numpy(), (raw - raw.mean()) / raw.std(),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(RuntimeError, match='one-shot'):
        pre.transform_fit()


def _resolved_rows(x, lm, k):
    """Rows whose k-th and (k+1)-th nearest landmark (float64) differ by
    more than 1e-5 of the norm scale: there both packages pick the same k
    neighbours."""
    d2 = ((x[:, None, :].astype(np.float64) - lm[None]) ** 2).sum(-1)
    d2.sort(axis=1)
    scale = 2 * float((x.astype(np.float64) ** 2).sum(1).max())
    return d2[:, k] - d2[:, k - 1] > 1e-5 * scale


@pytest.mark.parametrize('rounded', [False, True])
def test_landmark_correspondence_on_csr(monkeypatch, rounded):
    """CSR modalities with the JL-sketch FPS forced in both packages (and
    bf16 rounding at a patched BF16_LINK_ELEMS): identical FPS picks, the
    SpMM weight route, identical neighbour sets and weights within 1e-4 on
    the rows whose 8th and 9th landmark distances are resolved."""
    rng = np.random.RandomState(3)
    z = rng.randn(400, 6).astype(np.float32)
    xd = np.maximum(z @ rng.randn(6, 60) - 0.5, 0).astype(np.float32)
    yd = np.maximum(z @ rng.randn(6, 40) - 0.5, 0).astype(np.float32)
    X, Y = sparse.csr_matrix(xd), sparse.csr_matrix(yd)
    kw = dict(n_landmarks=32, k_interp=8, epoch_pd=100, verbose=False,
              distance_mode='euclidean', seed=1, precision='highest',
              factor_layout='sparse')
    patches = {'_FPS_BYTES_BUDGET': 1000}
    if rounded:
        patches['BF16_LINK_ELEMS'] = 1000
    _patched(monkeypatch, **patches)
    picks = []
    for sel in (lambda A, r: np.sort(tl._pick_landmarks(A, 32, 'fps', r,
                                                        'cpu')[0]),
                lambda A, r: jl._select_landmarks(A, 32, 'fps', r)):
        r = np.random.RandomState(1)       # landmark_correspondence's
        picks.append([sel(A, r) for A in (X, Y)])          # order
    ours, routes = _routes(tl.landmark_correspondence, X, Y, device='cpu',
                           **kw)
    ref = jl.landmark_correspondence(X, Y, **kw)
    for a, b in zip(*picks):
        np.testing.assert_array_equal(a, b)
    assert routes['fps_jl_sketch'] == 2
    assert routes['weights_spmm'] == 2
    for a, src, lx in (('x', xd, picks[0][0]), ('y', yd, picks[0][1])):
        ok = _resolved_rows(src, src[lx], 8)
        assert ok.mean() > 0.9
        mine = getattr(ours, 'i' + a).numpy()[ok]
        theirs = np.asarray(getattr(ref, 'i' + a))[ok]
        assert all(set(m) == set(t) for m, t in zip(mine, theirs))
        w_m = np.sort(getattr(ours, 'w' + a).numpy()[ok], axis=1)
        w_t = np.sort(np.asarray(getattr(ref, 'w' + a))[ok], axis=1)
        np.testing.assert_allclose(w_m, w_t, rtol=0, atol=1e-4)


def _csr_pair(n, f0, f1, seed, cut=0.8):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 4).astype(np.float32)
    z[: n // 2] += 3.0                        # two clusters
    a = np.maximum(z @ rng.randn(4, f0) - cut, 0).astype(np.float32)
    b = np.maximum(z @ rng.randn(4, f1) - cut, 0).astype(np.float32)
    labels = (np.arange(n) < n // 2).astype(int)
    return a, b, labels


def test_estimator_csr_fit_and_serve():
    """CSR modalities through the public fit: the same embeddings as the
    port's fit of the dense copies (the routes densify under the
    thresholds), FOSCTTM within 0.05 of jamie_tpu's fit of the same CSR
    (different sampling and noise streams), and transform / transform_one /
    modal_predict on CSR equal to the dense calls."""
    from jamie_tpu import JAMIE as JaxJAMIE
    from jamie_tpu_torch import JAMIE
    a, b, _ = _csr_pair(50, 20, 15, seed=5)
    data = [sparse.csr_matrix(a), sparse.csr_matrix(b).tocsc()]
    kw = dict(epoch_DNN=60, min_epochs=20, epoch_pd=40, pca_dim=(10, 8),
              batch_size=16, manual_seed=11, use_early_stop=False)
    tj = JAMIE(device='cpu', **kw)
    out = tj.fit_transform(dataset=data)
    assert all(d.format == 'csr' for d in tj.dataset)
    out_dense = JAMIE(device='cpu', **kw).fit_transform(dataset=[a, b])
    for o, od in zip(out, out_dense):
        np.testing.assert_allclose(o, od, rtol=1e-4, atol=1e-5)
    jj = JaxJAMIE(use_mesh=False, epoch_chunk=20, **kw)
    jout = jj.fit_transform(dataset=data)
    assert abs(tj.test_closer(out) - jj.test_closer(jout)) < 0.05
    re = tj.transform(data)
    for r, o in zip(re, out):
        np.testing.assert_allclose(r, o, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tj.transform_one(data[1], 1), out[1],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tj.modal_predict(data[0][:7], 0),
                               tj.modal_predict(a[:7], 0), rtol=1e-5,
                               atol=1e-5)


def test_estimator_atlas_routes(monkeypatch):
    """The 100,000-cell atlas fit's routes at 300 cells, with every
    threshold patched in both packages: corr_landmarks with the JL-sketch
    FPS, the SpMM weights and a rank-32 LowRankF; the RNA-like modality
    through the bf16-resident PCA and the wider ATAC-like one row-streamed
    by SpMM; the 'identity' sentinel P and 'diag' sampling; transform on the
    CSR inputs by SpMM. The correspondence factors agree with jamie_tpu's
    within 1e-4 of their largest entry and FOSCTTM is in its band (the PCA
    sketches and training streams differ)."""
    from jamie_tpu import JAMIE as JaxJAMIE
    import jamie_tpu.estimator as jest
    import jamie_tpu_torch.estimator as test_
    from jamie_tpu_torch import JAMIE
    from jamie_tpu_torch.ops.lowrank import LowRankF
    n = 300
    a, b, labels = _csr_pair(n, 60, 80, seed=2, cut=0.9)
    data = [sparse.csr_matrix(a), sparse.csr_matrix(b)]
    for m in (jest, test_):
        monkeypatch.setattr(m, 'SENTINEL_ENTRIES', 1000)
    kw = dict(corr_landmarks=32, pca_dim=(10, 10), batch_size=32,
              epoch_DNN=40, min_epochs=10, use_early_stop=False,
              epoch_pd=100, distance_mode='euclidean', solver_dtype='float32',
              manual_seed=3)
    # RNA 300 x 60 resident (36,000 bytes), ATAC 300 x 80 (48,000) not
    _patched(monkeypatch, _STREAM_THRESHOLD=1000, BF16_LINK_ELEMS=1000,
             DEFAULT_BUDGET_BYTES=40_000, _FPS_BYTES_BUDGET=1000)
    tj = JAMIE(device='cpu', **kw)
    out = tj.fit_transform(dataset=data)
    routes = timing.routes(tj.trace)
    jj = JaxJAMIE(use_mesh=False, epoch_chunk=20, **kw)
    jout = jj.fit_transform(dataset=data)
    re, served = _routes(tj.transform, data)
    assert served['pca_transform_spmm'] == 2
    imputed = tj.modal_predict(data[0][:50], 0)
    assert routes['fps_jl_sketch'] == 2 and routes['weights_spmm'] == 2
    assert routes['pca_resident_bf16'] == 1
    assert routes['pca_row_streamed'] == 1
    F = tj.match_result[0]
    assert type(F) is LowRankF and F.rank == 32
    assert tj.P == 'identity' and tj.sampling_method == 'diag'
    R = jj.match_result[0]
    for attr in ('u', 'v'):
        r = np.asarray(getattr(R, attr))
        np.testing.assert_allclose(getattr(F, attr).numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
    f_ours, f_ref = tj.test_closer(out), jj.test_closer(jout)
    assert f_ours < 0.25 and abs(f_ours - f_ref) < 0.05, (f_ours, f_ref)
    assert tj.test_LabelTA(out, [labels, labels]) > 0.9
    # the fit's embeddings come from the sketch scores, transform's from
    # the SpMM projection with bf16-rounded components: the same cells
    # embed to within a few percent of the embedding's spread
    for r, o in zip(re, out):
        assert np.abs(r - o).max() <= 0.05 * np.abs(o).max()
    assert imputed.shape == (50, 80) and np.isfinite(imputed).all()
