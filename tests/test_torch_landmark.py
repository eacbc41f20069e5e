"""jamie_tpu_torch.solvers.landmark against jamie_tpu.solvers.landmark on the
CPU, on the same seeded inputs: the interpolation weights, FPS indices,
landmark selection, the blocked cell-to-landmark weights and
landmark_correspondence's factors (euclidean mode, both layouts), and the
routes ROADMAP.md item 11 ported (tests/test_torch_sparse_data.py holds
them to jamie_tpu in full).

Tolerances: weights and factors are float32 with different summation
orders (squared distances via the Gram formula in both packages), held at
rtol 1e-5 (atol 1e-6 of unit-scale weights); after 200 prime-dual
iterations the factors are held at 1e-4 of their largest entry. Indices
are compared exactly on tie-free random data (torch.topk and lax.top_k may
order ties differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch

from jamie_tpu.solvers import landmark as jl
from jamie_tpu_torch.core import graphs
from jamie_tpu_torch.ops.lowrank import LowRankF, SparseLandmarkF
from jamie_tpu_torch.solvers import landmark as tl


def _paired(n=120, f0=20, f1=14, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 6).astype(np.float32)
    x = (z @ rng.randn(6, f0) + 0.05 * rng.randn(n, f0)).astype(np.float32)
    y = (z @ rng.randn(6, f1) + 0.05 * rng.randn(n, f1)).astype(np.float32)
    return x, y


@pytest.mark.parametrize('k', [1, 4, 8])
def test_interp_weights_match(k):
    d2 = np.random.RandomState(k).rand(50, 24).astype(np.float32) * 10
    idx, w = tl._interp_weights_sparse(torch.as_tensor(d2), k)
    ridx, rw = jl._interp_weights_sparse(jnp.asarray(d2), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(
        tl._interp_weights(torch.as_tensor(d2), k, 24).numpy(),
        np.asarray(jl._interp_weights(jnp.asarray(d2), k, 24)), rtol=1e-5,
        atol=1e-6)


def test_fps_indices_match():
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.randn(60, 5) + c * 6
                        for c in range(4)]).astype(np.float32)
    for first in (0, 17, 239):
        ours = tl._fps_indices_device(torch.as_tensor(x), first, 30)
        ref = jl._fps_indices_device(jnp.asarray(x), first, 30)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert ours[0] == first and len(np.unique(ours.numpy())) == 30


@pytest.mark.parametrize('method', ['fps', 'uniform'])
def test_select_landmarks_match(method):
    """Same RandomState draws: the same first cell and uniform subset."""
    x, _ = _paired(n=150)
    ours = np.sort(tl._pick_landmarks(x, 24, method, np.random.RandomState(5),
                                      device='cpu')[0])
    ref = jl._select_landmarks(x, 24, method, np.random.RandomState(5))
    np.testing.assert_array_equal(ours, ref)
    # a tensor source picks the same cells
    np.testing.assert_array_equal(
        np.sort(tl._pick_landmarks(torch.as_tensor(x), 24, method,
                                   np.random.RandomState(5),
                                   device='cpu')[0]), ref)
    with pytest.raises(ValueError):
        tl._pick_landmarks(x, 4, 'kmeanz', np.random.RandomState(0))


@pytest.mark.parametrize('sparse', [False, True])
def test_cell_to_landmark_weights_match(sparse):
    """Row blocks of 32 over 100 cells (four blocks, the last ragged)."""
    x, _ = _paired(n=100)
    lm = x[np.arange(0, 100, 7)]
    ours = tl._cell_to_landmark_weights(x, lm, 4, block=32, sparse=sparse,
                                        device='cpu')
    ref = jl._cell_to_landmark_weights(x, lm, 4, block=32, sparse=sparse)
    # a tensor source gives the same weights as a host array
    again = tl._cell_to_landmark_weights(torch.as_tensor(x), lm, 4,
                                         block=32, sparse=sparse)
    if sparse:
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
        ours, ref, again = ours[1], ref[1], again[1]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(again.numpy(), ours.numpy())


@pytest.mark.parametrize('layout', ['dense', 'sparse'])
def test_landmark_correspondence_factors_match(layout):
    x, y = _paired(n=140)
    kw = dict(n_landmarks=40, k_interp=4, epoch_pd=200, verbose=False,
              distance_mode='euclidean', factor_layout=layout, seed=11)
    ours = tl.landmark_correspondence(x, y, device='cpu', **kw)
    ref = jl.landmark_correspondence(x, y, **kw)
    assert isinstance(ours, SparseLandmarkF if layout == 'sparse'
                      else LowRankF)
    assert ours.shape == (140, 140) and ours.rank == 40
    if layout == 'sparse':
        for a in ('ix', 'iy'):
            np.testing.assert_array_equal(getattr(ours, a).numpy(),
                                          np.asarray(getattr(ref, a)))
    for a in ('u', 'v'):
        r = np.asarray(getattr(ref, a))
        np.testing.assert_allclose(getattr(ours, a).numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
    with pytest.raises(ValueError):
        tl.landmark_correspondence(x, y, device='cpu',
                                   **{**kw, 'factor_layout': 'bogus'})


def test_auto_layout_goes_sparse(monkeypatch):
    x, y = _paired(n=60)
    monkeypatch.setattr(tl, '_SPARSE_FACTOR_ENTRIES', 60 * 16 - 1)
    F = tl.landmark_correspondence(x, y, n_landmarks=16, k_interp=3,
                                   epoch_pd=20, verbose=False, device='cpu')
    assert isinstance(F, SparseLandmarkF)


def test_item_11_routes_raise(monkeypatch):
    """Scipy-sparse sources, host sources at the chunk-uploaded size and
    FPS past its device budget no longer raise: ROADMAP.md item 11 ported
    them. Each now runs and takes jamie_tpu's route (a CSR source the SpMM
    weights, a source at the patched upload limit the uploader, FPS past
    its budget the JL sketch, with jamie_tpu's picks)."""
    from jamie_tpu_torch.core import timing
    x, y = _paired(n=60)
    kw = dict(n_landmarks=16, epoch_pd=5, verbose=False, device='cpu')
    with timing.span('spmm') as sp:
        F = tl.landmark_correspondence(ss.csr_matrix(x), y, **kw)
    assert F.shape == (60, 60)
    routes = timing.routes(sp)
    assert routes['weights_spmm'] == 1
    assert routes['weights_dense'] == 1
    monkeypatch.setattr(tl, '_UPLOAD_ELEMS', 60 * 20)      # x: 60 x 20
    with timing.span('uploader') as sp:
        tl.landmark_correspondence(x, y, **kw)
    routes = timing.routes(sp)
    assert routes['weights_uploader'] == 1
    assert routes['weights_dense'] == 1      # y: 60 x 14
    monkeypatch.setattr(tl, '_FPS_BYTES_BUDGET', 1024)
    monkeypatch.setattr(jl, '_FPS_BYTES_BUDGET', 1024)
    picks, route = tl._pick_landmarks(x, 8, 'fps', np.random.RandomState(0),
                                      device='cpu')
    np.testing.assert_array_equal(
        np.sort(picks),
        jl._select_landmarks(x, 8, 'fps', np.random.RandomState(0)))
    assert route == 'fps_jl_sketch'


@pytest.mark.parametrize('n_landmarks', [2, 17, 55])
def test_fps_pick_step_matches_reference(n_landmarks):
    """One pick per step of the device loop (argmax, the index written at
    the device counter, the min-distance update), run L - 1 times, against
    jamie_tpu's fori_loop, exactly: from the one-step loop to every
    distinct row of the data; rows 0-4 are repeated as rows 55-59 (equal
    distances tie), and both packages pick the first index on ties. Past
    the 55 distinct rows every distance is a rounding residue of zero, and
    the two packages' Gram sums round differently."""
    rng = np.random.RandomState(11)
    x = rng.randn(60, 7).astype(np.float32)
    x[55:] = x[:5]
    for first in (0, 31):
        ours = tl._fps_indices_device(torch.as_tensor(x), first, n_landmarks)
        ref = jl._fps_indices_device(jnp.asarray(x), first, n_landmarks)
        assert ours.dtype == torch.long and ours.shape == (n_landmarks,)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        with graphs.plain_loops():
            again = tl._fps_indices_device(torch.as_tensor(x), first,
                                           n_landmarks)
        np.testing.assert_array_equal(again.numpy(), ours.numpy())


@pytest.mark.parametrize('layout', ['dense', 'sparse'])
def test_f_keeps_what_the_route_solved(layout):
    """F.landmarks: the picks sorted and in their pick order, the
    landmark distance matrices over the sorted picks' rows and F_L, from
    which the factors follow."""
    from jamie_tpu_torch.ops.distances import dataset_distance_matrix
    x, y = _paired(n=90)
    F = tl.landmark_correspondence(x, y, n_landmarks=16, epoch_pd=50,
                                   seed=5, factor_layout=layout,
                                   verbose=False, device='cpu')
    st = F.landmarks
    rng = np.random.RandomState(5)
    for picks, order, src in zip(st.picks, st.order, (x, y)):
        np.testing.assert_array_equal(picks, np.sort(order))
        np.testing.assert_array_equal(
            order, tl._pick_landmarks(src, 16, 'fps', rng, 'cpu')[0])
    for d, src, picks in zip(st.dist, (x, y), st.picks):
        np.testing.assert_array_equal(
            torch.as_tensor(d).numpy(),
            dataset_distance_matrix(src[picks], 'euclidean',
                                    device='cpu').numpy())
    assert tuple(st.f_l.shape) == (16, 16)
    if layout == 'sparse':
        assert st.f_l is F.f_l
    a_x = tl._cell_to_landmark_weights(x, x[st.picks[0]], 8, device='cpu')
    np.testing.assert_allclose(F.u.numpy(), (a_x @ st.f_l).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_select_landmarks_sorts_the_picks():
    """The fit's landmark rows are its picks sorted: the same cells as
    jamie_tpu's `_select_landmarks`, whose picks come sorted."""
    x, _ = _paired(n=60)
    picks, route = tl._pick_landmarks(x, 12, 'fps', np.random.RandomState(2),
                                      'cpu')
    assert route == 'fps_dense' and len(set(picks)) == 12
    F = tl.landmark_correspondence(x, x, n_landmarks=12, epoch_pd=5, seed=2,
                                   verbose=False, device='cpu')
    np.testing.assert_array_equal(F.landmarks.picks[0], np.sort(picks))
    np.testing.assert_array_equal(
        F.landmarks.picks[0],
        jl._select_landmarks(x, 12, 'fps', np.random.RandomState(2)))
