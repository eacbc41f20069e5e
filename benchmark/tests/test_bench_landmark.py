"""The landmark route's harness (`harness/landmark.py`) and its plain
reference (`reference_landmark.py`) at a tiny size on the CPU: the arms
it makes, the reference's stages against the program's, the
farthest-point test, whole runs of the cell, the control and the
faults, and the readers and the SpMM roofline of this route."""

import copy

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import control
import manifest
import reference as ref
import reference_landmark as rl
import run
from jamie_tpu_torch.core import timing
from test_bench_faults import LIMITS

CELL = 'bmmc_multiome.geodesic'
SEED = 2 ** 31 + 11
# The faults' limits; the tiny arms' FOSCTTM after 4 epochs reads ~0.3
TINY_LIMITS = dict(LIMITS, foscttm=0.5)


def tiny_atlas(bench, n=600, landmarks=64) -> dict:
    """The atlas configuration at ~600 cells x 300 / 1200 CSR columns with
    L = 64 and a short schedule; under 100M elements the program's stages
    are all float32."""
    cfg = copy.deepcopy(manifest.config(bench, 'bmmc_multiome'))
    cfg['shapes'] = [[n, 300], [n, 1200]]
    cfg['latent'] = 8
    cfg['kwargs'].update(epoch_pd=30, epoch_DNN=4, batch_size=64,
                         pca_dim=[32, 32], corr_landmarks=landmarks)
    cfg['precision'] = {k: 'float32' for k in cfg['precision']}
    return cfg


@pytest.fixture(scope='module')
def atlas(bench):
    return tiny_atlas(bench)


@pytest.fixture(scope='module')
def host(atlas):
    harness = manifest.harness(atlas)
    return harness.make_host(atlas, SEED, torch.device('cpu'))[0]


@pytest.fixture(scope='module')
def fitted(atlas, host):
    """One fit of the program on the tiny arms, and its output."""
    harness = manifest.harness(atlas)
    traffic = manifest.traffic('geodesic')
    rec = run.one_fit(host, run.fit_kwargs(atlas, traffic, SEED),
                      torch.device('cpu'), harness, atlas)
    return rec


def test_arms_are_csr_at_their_densities(atlas, host):
    assert [x.shape for x in host] == [(600, 300), (600, 1200)]
    for x, density, kind in zip(host, atlas['density'], atlas['kinds']):
        assert sp.isspmatrix_csr(x) and x.has_canonical_format
        assert x.dtype == np.float32 and x.indices.dtype == np.int32
        assert x.nnz / (x.shape[0] * x.shape[1]) == pytest.approx(
            density, rel=0.1)
        assert (x.data > 0).all()
        if kind == 'binary':
            assert (x.data == 1.0).all()
    again = manifest.harness(atlas).make_host(atlas, SEED, 'cpu')[0]
    for a, b in zip(host, again):
        assert (a != b).nnz == 0


def test_arms_are_made_in_row_blocks(atlas, monkeypatch):
    """The same arms whatever the block: rows are drawn block by block,
    so only the block size in rows differs."""
    harness = manifest.harness(atlas)
    whole = harness.make_host(atlas, 5, 'cpu')[0]
    monkeypatch.setattr(harness, 'BLOCK', 100)
    blocks = harness.make_host(atlas, 5, 'cpu')[0]
    for a, b in zip(whole, blocks):
        assert a.shape == b.shape
        assert abs(a.nnz - b.nnz) < 0.02 * a.nnz


def test_a_program_without_landmark_state_fails_at_once(atlas):
    """A program whose F keeps no `landmarks` (the parent of this
    configuration) fails at its first timed fit, where `produced` reads
    them."""
    class F:
        u = v = None

    class Fit:
        match_result = [F()]
    with pytest.raises(AttributeError, match='landmarks'):
        manifest.harness(atlas).produced(Fit())


def test_produced_keeps_the_landmark_state(fitted):
    out = fitted['out']
    assert fitted['solve_shape'] == [64, 64]
    assert fitted['solver_state_dtype'] == 'float32'
    assert [tuple(t.shape) for t in out['F_factors']] == [(600, 64),
                                                          (600, 64)]
    for p, o in zip(out['picks'], out['order']):
        assert torch.equal(p, torch.sort(o).values)
    assert [tuple(d.shape) for d in out['landmark_dist']] == [(64, 64)] * 2
    assert tuple(out['F_L'].shape) == (64, 64)
    assert 'dist' not in out and 'F' not in out


def test_reference_stages_match_the_program(atlas, host, fitted):
    """Each of the reference's stages from the fit's picks: the FPS order
    passes, the landmark distances, F_L and the factors agree."""
    harness = manifest.harness(atlas)
    out = fitted['out']
    want = harness.Reference(host, atlas, manifest.traffic('geodesic'),
                             'cpu')
    checks = want.fps(out)
    assert all(c['ok'] for c in checks) and max(
        c['worst'] for c in checks) < 1e-6
    st = want.stages(out['manual_seed'], out['picks'])
    for d, w in zip(out['landmark_dist'], st['dist']):
        assert ref.rel_fro(d, w) < 1e-6
    assert ref.rel_fro(out['F_L'], st['F_L']) < 1e-3
    assert ref.rel_fro(out['F_factors'][1], st['factors'][1]) < 1e-5
    nums = want.numbers(out, 'cpu')
    assert nums['dist'] < 1e-6 and nums['f'] < 1e-3
    # at this size F can be made dense: the gap from the (L, L) Grams is
    # the dense gap
    u, v = out['F_factors']
    u2, v2 = st['factors']
    assert nums['f'] == pytest.approx(ref.rel_fro(u @ v.T, u2 @ v2.T),
                                      rel=1e-6)


def test_fps_matches_the_program_and_rejects_a_swapped_pick():
    from jamie_tpu_torch.solvers import landmark
    rng = np.random.RandomState(0)
    x = rng.randn(300, 12).astype(np.float32)
    got = landmark._fps_indices_device(torch.as_tensor(x), 7, 40).numpy()
    s = torch.as_tensor(x).double()
    np.testing.assert_array_equal(rl.fps(s, 7, 40), got)
    assert rl.fps_check(s, got, 7)['ok']
    swapped = got.copy()
    swapped[[5, 30]] = swapped[[30, 5]]
    bad = rl.fps_check(s, swapped, 7)
    assert not bad['ok'] and bad['step'] == 5 and 'short' in bad['why']
    assert not rl.fps_check(s, got, 8)['ok']
    twice = got.copy()
    twice[9] = twice[3]
    assert rl.fps_check(s, twice, 7)['why'] == 'a cell picked twice'


def test_sketch_takes_the_programs_draws(monkeypatch):
    """Past the budget both sides draw the first pick, then the
    projection, from one RandomState; the reference's sketch is the
    program's SpMM sketch in float64."""
    from jamie_tpu_torch.solvers import landmark
    x = sp.random(200, 50, density=0.2, format='csr', dtype=np.float32,
                  random_state=1)
    monkeypatch.setattr(rl, 'FPS_BYTES', 0)
    (first, proj), = rl.draws(9, [x.shape])
    rng = np.random.RandomState(9)
    assert first == rng.randint(200)
    got = landmark._project_for_fps(x, rng, device='cpu')
    s = rl.sketch(x, proj, 'cpu')
    assert ref.rel_fro(got, s) < 1e-6


def test_weights_match_the_program():
    from jamie_tpu_torch.solvers import landmark
    x = sp.random(300, 80, density=0.2, format='csr', dtype=np.float32,
                  random_state=2)
    lm = x[np.arange(0, 300, 10)].toarray()
    got = landmark._cell_to_landmark_weights(x, lm, 8, device='cpu')
    want = rl.weights(x, lm, 8, 'cpu')
    assert float((got.double() - want).abs().max()) < 1e-5
    np.testing.assert_allclose(want.sum(1).numpy(), 1.0, rtol=1e-12)


def test_lowrank_gap_is_the_dense_gap():
    g = torch.Generator().manual_seed(3)
    u, v, u2, v2 = (torch.rand((n, 16), generator=g, dtype=torch.float64)
                    for n in (70, 50, 70, 50))
    u = u2 + 1e-3 * u
    dense = ref.rel_fro(u @ v.T, u2 @ v2.T)
    assert rl.lowrank_gap(u, v, u2, v2) == pytest.approx(dense, rel=1e-9)
    assert rl.lowrank_gap(u2, v2, u2, v2) < 1e-7


def test_pca_basis_is_the_gram_subspace():
    x = sp.random(120, 400, density=0.1, format='csr', dtype=np.float32,
                  random_state=4)
    b, w = rl.pca_basis(x, 6, 'cpu', iters=40)
    b2, w2 = ref.pca_subspace(ref.gram(x.toarray(), 'cpu'), 6, iters=40)
    assert ref.subspace_sine(b2, b) < 1e-8
    assert torch.allclose(w[:6], w2[:6], rtol=1e-9)


def test_geodesic_breaks_exact_ties_as_argpartition():
    """Binary rows: distances tie exactly, and the reference keeps the
    neighbours numpy's argpartition keeps, so it matches the program's
    geodesic matrix bit for bit with nothing undecided."""
    from jamie_tpu_torch.ops.distances import geodesic_distances
    x = (np.random.RandomState(6).rand(150, 60) < 0.1).astype(np.float32)
    d = ref.euclidean(ref.gram(x, 'cpu'))
    g, undecided = rl.geodesic(d, tie=1e-5)
    assert not undecided.any()
    port = geodesic_distances(x, device='cpu')
    assert torch.equal(torch.as_tensor(port), g)


@pytest.fixture
def any_gap(atlas, monkeypatch):
    """The harness with the PCA judged at any gap (the tiny arms leave
    lambda_33 / lambda_32 above 0.5), for every lookup of it."""
    harness = manifest.harness(atlas)
    monkeypatch.setattr(harness, 'GAP', 1.0)
    monkeypatch.setattr(manifest, 'harness', lambda config: harness)
    return harness


def test_cell_is_correct_on_the_cpu(bench, atlas, any_gap):
    """A whole run of the cell at the tiny size, every number judged."""
    result = run.run_cell(CELL, SEED, 0.0, False, device='cpu',
                          bench=bench, config=atlas, limits=TINY_LIMITS)
    assert result['correct'], result['checks']
    assert all(c['value'] is not None for c in result['checks'].values())


def test_control_and_faults_are_not_correct(bench, atlas, any_gap):
    """The control (its own picks on a TF32 sketch, TF32 distances,
    weights, solve, PCA and model) and each fault are not correct."""
    row = next(control.readings(CELL, [SEED], device='cpu', bench=bench,
                                config=atlas, limits=TINY_LIMITS))
    assert row['program']['correct'] is True, row['program']
    assert row['control']['correct'] is False, row['control']
    for name in control.FAULTS:
        assert row[f'fault_{name}']['correct'] is False, name


# ------------------------------------------------------------ readers
S = 1_000_000_000


def _span(name, start, end, children=(), **counters):
    s = timing.Span(name, **counters)
    s.start_ns, s.end_ns = int(start * S), int(end * S)
    s.children = list(children)
    for c in s.children:
        c.parent = s
    return s


def _root(k: float):
    csr = [_span('residency.csr', 0.1, 0.1 + 0.5 * k, nnz=10,
                 bytes=84, copy_s=0.4 * k) for _ in range(2)]
    sel = _span('landmark.selection', 0.0, 2.0 * k, csr, L=[8, 8],
                spmm=[[10, 256, 30, 8], [12, 256, 40, 8]])
    bases = [_span('distances.base', 2.0 * k, 2.5 * k, route='k3'),
             _span('distances.base', 2.5 * k, 3.0 * k,
                   route='distance_resident_bf16')]
    dist = _span('landmark.distances', 2.0 * k, 3.0 * k, bases, L=[8, 6],
                 features=[30, 40])
    solve = _span('landmark.solve', 3.0 * k, 4.0 * k, iterations=500)
    weights = _span('landmark.weights', 4.0 * k, 7.0 * k,
                    spmm=[[10, 8, 30, 8], [10, 1, 30, 8]])
    corr = _span('Correspondence', 0.0, 7.0 * k, [sel, dist, solve,
                                                   weights])
    return _span('fit', 0.0, 8.0 * k, [
        _span('Distance', 0.0, 0.0), corr, _span('Mapping', 7.0 * k,
                                                   8.0 * k)])


def _record(roots, trace=None, peaks=None, k3_launches=1):
    return {'fits': [{'phases': {c.name: round(c.seconds, 3)
                                 for c in r.children},
                      'launches': {'pairwise_euclidean': k3_launches}}
                     for r in roots],
            'trace': trace, 'peaks': peaks}


READ = {'landmark.selection_s': 2.0 * 1.5, 'landmark.weights_s': 3.0 * 1.5,
        'landmark.solve_ms_per_iter': 1000.0 * 1.5 / 500,
        'residency.csr_s': 2 * 0.5 * 1.5}


@pytest.mark.parametrize('name', sorted(READ))
def test_landmark_readers_read_the_spans(monkeypatch, name):
    roots = [_root(k) for k in (3.0, 1.0, 2.0)]
    monkeypatch.setattr(timing, 'recent_fits', lambda: roots)
    assert manifest.reader(name)(_record(roots[1:])) == pytest.approx(
        READ[name])
    # a fit without the spans or their counters (an older program)
    bare = [_span('fit', 0.0, 1.0, [_span('Correspondence', 0.0, 1.0)])]
    monkeypatch.setattr(timing, 'recent_fits', lambda: bare)
    assert manifest.reader(name)(_record(bare)) is None


def test_spmm_roofline_reads_counters_and_trace(monkeypatch):
    from roofline import peaks
    h100 = peaks('NVIDIA H100 80GB HBM3')
    roots = [_root(1.0)]
    monkeypatch.setattr(timing, 'recent_fits', lambda: roots)
    trace = {'kernels': {'void cusparse::csrmm_alg2_kernel<float>': (2e-6, 4),
                         'pd_update_kernel': (1.0, 9)}}
    read = manifest.reader('spmm_roofline')
    calls = [[10, 256, 30, 8], [12, 256, 40, 8], [10, 8, 30, 8],
             [10, 1, 30, 8]]
    from roofline import spmm
    bound = sum(spmm.bound_s(*c, h100) for c in calls)
    assert read(_record(roots, trace, h100)) == pytest.approx(
        100.0 * bound / 2e-6)
    assert read(_record(roots, {'kernels': {}}, h100)) is None
    assert read(_record(roots, trace, None)) is None
    bare = [_span('fit', 0.0, 1.0, [_span('Correspondence', 0.0, 1.0)])]
    monkeypatch.setattr(timing, 'recent_fits', lambda: bare)
    assert read(_record(bare, trace, h100)) is None


def test_k3_landmark_roofline_reads_the_distances_spans(monkeypatch):
    """The K3 call of the modality whose landmark distances took the `k3`
    route (8 x 8 x 30), over K3's device time; None where K3 launched
    another number of times, or the spans lack the counters."""
    from roofline import k3, peaks
    h100 = peaks('NVIDIA H100 80GB HBM3')
    roots = [_root(1.0)]
    monkeypatch.setattr(timing, 'recent_fits', lambda: roots)
    trace = {'kernels': {'pairwise_tf32x3_kernel<64>': (3e-6, 1),
                         'void cusparse::csrmm_alg2_kernel<float>': (1.0, 4)}}
    read = manifest.reader('k3_roofline.landmark')
    assert read(_record(roots, trace, h100)) == pytest.approx(
        100.0 * k3.bound_s(8, 8, 30, True, h100) / 3e-6)
    assert read(_record(roots, trace, h100, k3_launches=2)) is None
    assert read(_record(roots, {'kernels': {}}, h100)) is None
    bare = [_span('fit', 0.0, 1.0, [_span('Correspondence', 0.0, 1.0, [
        _span('landmark.distances', 0.0, 1.0, L=[8, 6])])])]
    monkeypatch.setattr(timing, 'recent_fits', lambda: bare)
    assert read(_record(bare, trace, h100)) is None


def test_spmm_counts():
    from roofline import peaks, spmm
    h100 = peaks('NVIDIA H100 80GB HBM3')
    assert spmm.ops(10, 3) == 60
    assert spmm.bytes_per_call(10, 3, 7, 5) == 80 + 4 * 3 * 12
    # the ATAC arm against 2048 landmarks: 403.3M nonzeros, bound by the
    # FP32 operations, 24.7 ms
    b = spmm.bound_s(403_300_000, 2048, 116_490, 8192, h100)
    assert b == pytest.approx(2 * 403_300_000 * 2048 / 67e12)
    # a one-column product (the row norms) is bound by its bytes
    assert spmm.bound_s(1000, 1, 50, 40, h100) == pytest.approx(
        (8000 + 4 * 90) / 3.35e12)

