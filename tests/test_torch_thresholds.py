"""Threshold boundaries, site by site: with n * f just below, exactly at and
just above each threshold, the port takes the route jamie_tpu takes. The
sites compare differently (jamie_tpu's own operators):

- `>`  ops/distances._FEATURE_CHUNK_THRESHOLD (the bf16-resident Gram);
- `>`  preprocess._STREAM_THRESHOLD in the PCA fit;
- `>`  solvers/landmark._FPS_BYTES_BUDGET (the JL-sketch FPS);
- `>=` preprocess._STREAM_THRESHOLD in PCA.transform (the uploader);
- `>=` the 100M-element uploader limit of the landmark weights (a literal in
  jamie_tpu, so that site runs at its real size on a broadcast array, both
  routes stopped at their first step);
- `>=` core/residency.BF16_LINK_ELEMS for DeviceCSR's bf16 values;
- `<`  BF16_LINK_ELEMS for ChunkUploader.exact.

Patchable thresholds are set to n * f + delta in both packages."""

import numpy as np
import pytest
import scipy.sparse as sp

import jamie_tpu.core.residency as jr
import jamie_tpu.ops.distances as jd
import jamie_tpu.preprocess as jp
import jamie_tpu.solvers.landmark as jl
import jamie_tpu_torch.core.residency as tr
import jamie_tpu_torch.ops.distances as td
import jamie_tpu_torch.preprocess as tp
import jamie_tpu_torch.solvers.landmark as tl

DELTAS = [-1, 0, 1]


@pytest.fixture(autouse=True)
def _fresh():
    tr.clear_residency_cache()
    jr.clear_residency_cache()
    tr.route_counts.clear()
    yield
    tr.clear_residency_cache()
    jr.clear_residency_cache()


def _data(n=24, f=10, seed=0):
    return np.random.RandomState(seed).rand(n, f).astype(np.float32)


def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(name)
        return orig(*a, **k)
    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize('delta', DELTAS)
def test_distance_threshold_is_strict(monkeypatch, delta):
    x = _data()
    for m in (td, jd):
        monkeypatch.setattr(m, '_FEATURE_CHUNK_THRESHOLD', x.size + delta)
    calls = []
    _spy(monkeypatch, jr, 'device_bf16', calls)
    td.dataset_distance_matrix(x, 'euclidean', device='cpu')
    jd.dataset_distance_matrix(x, 'euclidean')
    ours = tr.route_counts['distance_resident_bf16'] == 1
    assert ours == bool(calls) == (x.size > x.size + delta)


@pytest.mark.parametrize('delta', DELTAS)
def test_pca_fit_threshold_is_strict(monkeypatch, delta):
    x = _data()
    for m in (tp, jp):
        monkeypatch.setattr(m, '_STREAM_THRESHOLD', x.size + delta)
    calls = []
    _spy(monkeypatch, jr, 'device_bf16', calls)
    tp.PCA(3, device='cpu').fit(x)
    jp.PCA(3).fit(x)
    ours = tr.route_counts['pca_resident_bf16'] == 1
    assert ours == bool(calls) == (x.size > x.size + delta)


@pytest.mark.parametrize('delta', DELTAS)
def test_fps_budget_is_strict(monkeypatch, delta):
    x = _data(40, 12)
    for m in (tl, jl):
        monkeypatch.setattr(m, '_FPS_BYTES_BUDGET', 4 * x.size + delta)
    calls = []
    _spy(monkeypatch, jl, '_project_for_fps', calls)
    ours = tl._select_landmarks(x, 5, 'fps', np.random.RandomState(0),
                                device='cpu')
    ref = jl._select_landmarks(x, 5, 'fps', np.random.RandomState(0))
    assert (tr.route_counts['fps_jl_sketch'] == 1) == bool(calls) == (
        4 * x.size > 4 * x.size + delta)
    if not calls:
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('delta', DELTAS)
def test_pca_transform_threshold_is_inclusive(monkeypatch, delta):
    x = _data(100, 8)
    ours, ref = tp.PCA(3, device='cpu').fit(x), jp.PCA(3).fit(x)
    for m in (tp, jp):
        monkeypatch.setattr(m, '_STREAM_THRESHOLD', x.size + delta)
    calls = []
    _spy(monkeypatch, jr, 'ChunkUploader', calls)
    out = ours.transform(x, row_chunk_bytes=64)
    ref_out = ref.transform(x, row_chunk_bytes=64)
    assert (tr.route_counts['pca_transform_uploader'] == 1) == bool(calls) \
        == (x.size >= x.size + delta)
    np.testing.assert_allclose(out, ref_out, rtol=1e-4, atol=1e-4)


class _Stop(Exception):
    pass


# n x f just below, at and just above 100,000,000 elements
_WEIGHT_SHAPES = {-1: (9999, 10001), 0: (10000, 10000), 1: (5882353, 17)}


@pytest.mark.parametrize('delta', DELTAS)
def test_landmark_weights_upload_limit_is_inclusive(monkeypatch, delta):
    """A dense host source of 100M elements or more streams through the
    uploader, a smaller one goes to the pairwise distance directly; each
    route is stopped at its first call (the source is a broadcast row)."""
    n, f = _WEIGHT_SHAPES[delta]
    x = np.broadcast_to(np.ones((1, f), np.float32), (n, f))
    lm = np.ones((2, f), np.float32)
    routes = []

    def stop(route):
        def fn(*a, **k):
            routes.append(route)
            raise _Stop
        return fn
    for up_mod, pw_mod, pw_name in ((tr, tl, 'pairwise_euclidean'),
                                    (jr, jl, 'pairwise_sq_euclidean')):
        monkeypatch.setattr(up_mod, 'ChunkUploader', stop('uploader'))
        monkeypatch.setattr(pw_mod, pw_name, stop('direct'))
    with pytest.raises(_Stop):
        tl._cell_to_landmark_weights(x, lm, 2, block=8, device='cpu')
    with pytest.raises(_Stop):
        jl._cell_to_landmark_weights(x, lm, 2, block=8)
    want = 'uploader' if n * f >= 100_000_000 else 'direct'
    assert routes == [want, want]


@pytest.mark.parametrize('delta', DELTAS)
def test_device_csr_bf16_limit_is_inclusive(monkeypatch, delta):
    X = sp.csr_matrix(_data())
    for m in (tr, jr):
        monkeypatch.setattr(m, 'BF16_LINK_ELEMS', 240 + delta)
    ours, ref = tr.DeviceCSR(X, 'cpu'), jr.DeviceCSR(X)
    assert ours.bf16 == (str(ref.ev.dtype) == 'bfloat16') == (
        240 >= 240 + delta)
    np.testing.assert_array_equal(ours.rows(0, 24).numpy(),
                                  np.asarray(ref.rows(0, 24)))


@pytest.mark.parametrize('delta', DELTAS)
@pytest.mark.parametrize('source', ['dense', 'csr'])
def test_uploader_exact_limit_is_strict(monkeypatch, delta, source):
    x = _data()
    arr = x if source == 'dense' else sp.csr_matrix(x)
    for m in (tr, jr):
        monkeypatch.setattr(m, 'BF16_LINK_ELEMS', 240 + delta)
    ours, ref = tr.ChunkUploader(arr, 'cpu'), jr.ChunkUploader(arr)
    assert ours.exact == ref.exact == (240 < 240 + delta)
    np.testing.assert_array_equal(ours.rows(0, 24).numpy(),
                                  np.asarray(ref.rows(0, 24)))
