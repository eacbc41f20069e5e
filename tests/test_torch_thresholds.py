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

Patchable thresholds are set to n * f + delta in both packages. The last
tests hold the estimator's decisions at the port's own defaults (the
values measured on the card), where they deliberately differ from
jamie_tpu's, and the byte model behind them."""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp

import jamie_tpu.core.residency as jr
import jamie_tpu.estimator as je
import jamie_tpu.ops.distances as jd
import jamie_tpu.preprocess as jp
import jamie_tpu.solvers.landmark as jl
import jamie_tpu_torch.core.residency as tr
import jamie_tpu_torch.core.timing as timing
import jamie_tpu_torch.estimator as te
import jamie_tpu_torch.ops.distances as td
import jamie_tpu_torch.preprocess as tp
import jamie_tpu_torch.probes as tprobes
import jamie_tpu_torch.solvers.landmark as tl

# the submodule: jamie_tpu_torch.solvers binds the function prime_dual
tpd = importlib.import_module('jamie_tpu_torch.solvers.prime_dual')

DELTAS = [-1, 0, 1]


@pytest.fixture(autouse=True)
def _fresh():
    tr.clear_residency_cache()
    jr.clear_residency_cache()
    yield
    tr.clear_residency_cache()
    jr.clear_residency_cache()


def _data(n=24, f=10, seed=0):
    return np.random.RandomState(seed).rand(n, f).astype(np.float32)


def _routes(fn, *a, **k):
    """fn(*a, **k) inside a span: its output and the routes it took."""
    with timing.span('call') as call:
        out = fn(*a, **k)
    return out, timing.routes(call)


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
    _, routes = _routes(td.dataset_distance_matrix, x, 'euclidean',
                        device='cpu')
    jd.dataset_distance_matrix(x, 'euclidean')
    ours = routes['distance_resident_bf16'] == 1
    assert ours == bool(calls) == (x.size > x.size + delta)


@pytest.mark.parametrize('delta', DELTAS)
def test_pca_fit_threshold_is_strict(monkeypatch, delta):
    x = _data()
    for m in (tp, jp):
        monkeypatch.setattr(m, '_STREAM_THRESHOLD', x.size + delta)
    calls = []
    _spy(monkeypatch, jr, 'device_bf16', calls)
    _, routes = _routes(tp.PCA(3, device='cpu').fit, x)
    jp.PCA(3).fit(x)
    ours = routes['pca_resident_bf16'] == 1
    assert ours == bool(calls) == (x.size > x.size + delta)


@pytest.mark.parametrize('delta', DELTAS)
def test_fps_budget_is_strict(monkeypatch, delta):
    x = _data(40, 12)
    for m in (tl, jl):
        monkeypatch.setattr(m, '_FPS_BYTES_BUDGET', 4 * x.size + delta)
    calls = []
    _spy(monkeypatch, jl, '_project_for_fps', calls)
    picks, route = tl._pick_landmarks(x, 5, 'fps', np.random.RandomState(0),
                                      device='cpu')
    ours = np.sort(picks)
    ref = jl._select_landmarks(x, 5, 'fps', np.random.RandomState(0))
    assert (route == 'fps_jl_sketch') == bool(calls) == (
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
    out, routes = _routes(ours.transform, x, row_chunk_bytes=64)
    ref_out = ref.transform(x, row_chunk_bytes=64)
    assert (routes['pca_transform_uploader'] == 1) == bool(calls) \
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


# ------------------------------------------------ the card's own defaults
# The estimator's route globals at their defaults, without patching: each
# decision at the value - 1, at it and at it + 1 (jamie_tpu's operators:
# `<=` for f32 state, `>` for the landmark route).


@pytest.mark.parametrize('delta', DELTAS)
def test_default_state_dtype_boundary(delta):
    jm = te.JAMIE(device='cpu')
    v = te.DENSE_F32_STATE_ENTRIES
    assert jm._resolved_state_dtype(v + delta) == (
        'float32' if v + delta <= v else 'bfloat16')


@pytest.mark.parametrize('delta', DELTAS)
def test_default_landmark_boundary(delta):
    jm = te.JAMIE(device='cpu')
    v = te.LANDMARK_AUTO_ENTRIES
    assert jm._takes_landmarks(v + delta) == (v + delta > v)
    # corr_landmarks forces the route; a given F never takes it
    assert te.JAMIE(device='cpu', corr_landmarks=8)._takes_landmarks(1)
    given = te.JAMIE(device='cpu', match_result=['zeros'])
    assert not given._takes_landmarks(v + 1)


def test_default_dense_route_stays_under_k1_int32_guard():
    """K1 refuses m * n >= 2^31 on the card (ops/pd_update._route): the
    largest dense F the defaults allow is below it, and f32 state is
    chosen only inside the dense band."""
    assert te.LANDMARK_AUTO_ENTRIES < 2 ** 31
    assert te.SENTINEL_ENTRIES < te.DENSE_F32_STATE_ENTRIES \
        < te.LANDMARK_AUTO_ENTRIES


class _Decided(Exception):
    pass


def _decision(module, cls, n, monkeypatch, n1=None, **kw):
    """The route `cls().fit_transform` picks for n x n cells (n x n1 with
    n1), read just after the decision: the distance phase that follows
    raises. The modalities are broadcast rows, so no n x f array exists."""
    def stop(self, *a, **k):
        raise _Decided
    monkeypatch.setattr(cls, 'compute_distances', stop)
    jm = cls(**kw)
    x, y = (np.broadcast_to(np.ones((1, 4), np.float32), (rows, 4))
            for rows in (n, n if n1 is None else n1))
    with pytest.raises(_Decided):
        jm.fit_transform(dataset=[x, y])
    return jm._use_landmarks


def test_landmark_threshold_deviates_from_jamie_tpu(monkeypatch):
    """Deliberate deviation: between jamie_tpu's LANDMARK_AUTO_ENTRIES
    and the port's, jamie_tpu takes the approximate landmark route and the
    port the exact dense one (the card holds that dense fit)."""
    assert je.LANDMARK_AUTO_ENTRIES < te.LANDMARK_AUTO_ENTRIES
    n = int(np.sqrt((je.LANDMARK_AUTO_ENTRIES + te.LANDMARK_AUTO_ENTRIES)
                    / 2))
    assert je.LANDMARK_AUTO_ENTRIES < n * n <= te.LANDMARK_AUTO_ENTRIES
    assert _decision(je, je.JAMIE, n, monkeypatch)
    assert not _decision(te, te.JAMIE, n, monkeypatch, device='cpu')


@pytest.mark.parametrize('state_dtype', ['float32', 'bfloat16'])
def test_state_byte_model(state_dtype):
    """The bytes the dense solver keeps per (N0 * N1) entry, the model
    behind DENSE_F32_STATE_ENTRIES and LANDMARK_AUTO_ENTRIES: init_state's
    square tensors (F, M1, M2, FKy, KxFKy, Kx, Ky) hold exactly
    probes.STATE_BYTES_PER_ENTRY per entry with bf16 GEMMs; the rest is
    O(m + n): the vectors S, Mu, Lambda and the carried column sums, the
    scalar a and the int32 step counter."""
    m = 12
    K = np.random.RandomState(0).rand(m, m).astype(np.float32)
    Kx, Ky, _, state, _ = tpd.init_state(K, K, 4, 4, state_dtype, True,
                                         'cpu')
    tensors = [Kx, Ky, *state.values()]
    square = sum(t.numel() * t.element_size() for t in tensors
                 if t.numel() == m * m)
    rest = sum(t.numel() * t.element_size() for t in tensors
               if t.numel() != m * m)
    assert square == tprobes.STATE_BYTES_PER_ENTRY[state_dtype] * m * m
    assert rest <= 4 * (4 * m + 2)


# The `fit` probe's peaks on one H100 80GB HBM3 at 700.00 W (N0, N1, state
# dtype, max_memory_allocated bytes): the square rungs and the unequal
# pairs at 400M entries that estimator.DENSE_PEAK_TENTHS was fitted to
_FIT_PEAKS = [
    (28000, 28000, 'float32', 63_035_905_024),
    (29154, 29154, 'float32', 68_324_371_968),
    (32000, 32000, 'float32', 82_309_328_384),
    (28284, 14142, 'float32', 39_237_112_832),
    (14142, 28284, 'float32', 34_720_016_384),
    (34641, 11547, 'float32', 48_245_523_968),
    (30000, 30000, 'bfloat16', 65_148_409_344),
    (32000, 32000, 'bfloat16', 74_086_378_496),
    (33000, 33000, 'bfloat16', 78_811_118_080),
    (28284, 14142, 'bfloat16', 35_636_396_032),
    (14142, 28284, 'bfloat16', 32_754_186_752),
    (34641, 11547, 'bfloat16', 44_013_335_040),
]


@pytest.mark.parametrize('n0,n1,state_dtype,peak', _FIT_PEAKS)
def test_dense_peak_model_matches_the_fit_probe(n0, n1, state_dtype, peak):
    """The byte model the dense thresholds compare by predicts each
    measured peak within 2%, square or not."""
    a, b, c = te.DENSE_PEAK_TENTHS[state_dtype]
    model = (a * n0 * n1 + b * n0 * n0 + c * n1 * n1) / 10
    assert abs(model / peak - 1) < 0.02


@pytest.mark.parametrize('state_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [1, 1047, 24000, 29154, 30000, 46340])
def test_dense_entries_of_a_square_pair_is_n_squared(state_dtype, n):
    assert te.dense_entries(n, n, state_dtype) == n * n


# Unequal pairs at the thresholds by N0 * N1 (within 0.01%) that ran out
# of memory on the card in the `fit` probe: (N0, N1, state dtype)
_RAN_OUT = [(41231, 20615, 'float32'), (20615, 41231, 'float32'),
            (50498, 16833, 'float32'), (42426, 21213, 'bfloat16')]


@pytest.mark.parametrize('n0,n1,state_dtype', _RAN_OUT)
def test_unequal_pairs_that_ran_out_take_the_landmark_route(
        monkeypatch, n0, n1, state_dtype):
    """By N0 * N1 each pair sat at its state dtype's threshold; by
    `dense_entries` it is past it, and the default fit takes the landmark
    route."""
    limit = (te.DENSE_F32_STATE_ENTRIES if state_dtype == 'float32'
             else te.LANDMARK_AUTO_ENTRIES)
    assert abs(n0 * n1 / limit - 1) < 1e-4
    assert te.dense_entries(n0, n1, state_dtype) > limit
    assert _decision(te, te.JAMIE, n0, monkeypatch, n1=n1, device='cpu')


def test_phase_l_pair_is_dense_with_f32_state(monkeypatch):
    """24,000 cells per side (chip_smoke phase L): dense, f32 state."""
    jm = te.JAMIE(device='cpu')
    assert jm._resolved_state_dtype(
        te.dense_entries(24000, 24000, 'float32')) == 'float32'
    assert not _decision(te, te.JAMIE, 24000, monkeypatch, device='cpu')
