"""The program's spans (`jamie_tpu_torch/core/timing.py`) on the CPU: the
tree each `JAMIE().fit_transform` leaves, the phase timings read off it,
the counters against the loops' own, the profiler's `jamie.<name>` ranges
and the estimator's console report."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from jamie_tpu_torch import JAMIE
from jamie_tpu_torch.core import timing

KW = dict(epoch_DNN=6, min_epochs=2, epoch_chunk=2, batch_size=32,
          pca_dim=(8, 6), epoch_pd=20, log_pd=10, log_DNN=10_000,
          use_early_stop=False)
PHASES = ('Distance', 'Correspondence', 'Mapping')
MAPPING = ('Preprocessing', 'Trainer setup', 'Training', 'Output')


def _data(n=80, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 4)
    return [(z @ rng.randn(4, w) + 0.1 * rng.randn(n, w)).astype(np.float32)
            for w in (30, 12)]


class _CountingRange:
    """The profiler range's stand-in: counts the ranges entered."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def _fit(mode, **kw):
    """A tiny fit; its estimator, its stdout, the loops' step counts and
    the trainer's epochs by route, from its span tree."""
    jm = JAMIE(device='cpu', distance_mode=mode, **{**KW, **kw})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jm.fit_transform(dataset=_data())
    routes = timing.routes(jm.trace)
    steps = {k: v for k, v in routes.items()
             if '/' in k and not k.startswith('epochs/')}
    epochs = {k.split('/')[1]: v for k, v in routes.items()
              if k.startswith('epochs/')}
    return jm, out.getvalue(), steps, epochs


@pytest.fixture(scope='module', params=['euclidean', 'geodesic'])
def fitted(request, tmp_path_factory):
    """Per distance mode: one fit with no profiler (its profiler ranges
    counted) and one under `timing.trace`, whose Chrome trace and raw
    events are kept."""
    mode = request.param
    real = timing.profiler_range
    _CountingRange.entered = 0
    timing.profiler_range = _CountingRange
    try:
        plain = _fit(mode)
    finally:
        timing.profiler_range = real
    entered = _CountingRange.entered
    log_dir = tmp_path_factory.mktemp('trace')
    with timing.trace(str(log_dir)) as prof:
        traced = _fit(mode)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith('jamie.')]
    chrome = json.load(open(log_dir / 'trace.json'))
    return dict(mode=mode, plain=plain, traced=traced, entered=entered,
                events=events, chrome=chrome)


def test_span_tree_nests_and_the_phases_cover_the_fit(fitted):
    for jm, *_ in (fitted['plain'], fitted['traced']):
        root = jm.trace
        assert root.name == 'fit' and root.parent is None
        for sp in root.walk():
            assert sp.fit_id == root.fit_id
            assert sp.end_ns is not None and sp.end_ns >= sp.start_ns
            kids = sp.children
            for c in kids:
                assert c.parent is sp
                assert sp.start_ns <= c.start_ns <= c.end_ns <= sp.end_ns
            for a, b in zip(kids, kids[1:]):
                assert a.end_ns <= b.start_ns, (a, b)
        assert [c.name for c in root.children] == list(PHASES)
        assert [c.name for c in root.child('Mapping').children] == \
            list(MAPPING)
        covered = sum(c.seconds for c in root.children)
        assert covered >= 0.95 * root.seconds
        assert root.self_seconds == pytest.approx(root.seconds - covered)


def test_phase_timings_are_read_off_the_spans(fitted):
    jm = fitted['plain'][0]
    root = jm.trace
    assert jm.phase_timings == {n: round(root.child(n).seconds, 3)
                                for n in PHASES}
    mapping = root.child('Mapping')
    assert jm._mapping_timings == {n: mapping.child(n).seconds
                                   for n in MAPPING}
    assert list(jm._mapping_timings) == list(MAPPING)
    replay = root.find('trainer.replay')
    assert len(replay) == 1 and jm.fit_seconds == replay[0].seconds


def test_distance_spans_per_modality(fitted):
    root = fitted['plain'][0].trace
    distance = root.child('Distance')
    names = [c.name for c in distance.children]
    if fitted['mode'] == 'geodesic':
        assert names == ['distances.base', 'distances.knn_graph',
                         'distances.shortest_path'] * 2
        for knn in distance.find('distances.knn_graph'):
            assert knn.counters['rounds'] >= 1
            assert knn.counters['k'] >= 5
            assert knn.counters['bridged'] is False
    else:
        assert names == ['distances.base'] * 2
    for base in distance.find('distances.base'):
        assert base.counters['route'] == 'k3'


def test_replay_counters_equal_the_loops_counts(fitted):
    jm, _, steps, epochs = fitted['plain']
    root = jm.trace
    (pd,) = root.find('prime_dual.replay')
    assert pd.counters == {'steps': KW['epoch_pd'], 'replays': 0,
                           'loops': {'prime_dual/cpu': KW['epoch_pd']}}
    assert steps == {'prime_dual/cpu': pd.counters['steps']}
    (tr,) = root.find('trainer.replay')
    assert tr.counters['loops'] == {'epochs/eager': KW['epoch_DNN']}
    assert epochs == {'eager': tr.counters['epochs']}
    assert tr.counters['epochs'] == KW['epoch_DNN']
    assert tr.counters['steps'] == \
        tr.counters['epochs'] * jm.trainer.len_dataloader
    # one wait for each chunk the host read, no capture on the CPU
    assert len(tr.find('trainer.wait')) == KW['epoch_DNN'] // KW['epoch_chunk']
    assert not root.find('trainer.capture') and not root.find(
        'graphs.capture')
    # the CPU keeps the block tails' composed ops
    assert tr.counters['blocks_fused'] == 0
    # on the CPU: no device time, no device memory
    assert all(sp.device_s is None and sp.memory_allocated is None
               for sp in root.walk())
    assert root.find('prime_dual.setup')
    assert [sp.counters['route'] for sp in root.find('preprocess.fit')] == \
        ['pca_direct'] * 2


def test_spans_are_profiler_ranges(fitted):
    """Each span of the traced fit is a `jamie.<name>` host event of the
    profiler, on its clock: the same interval within 1 ms once the root's
    offset is taken out; and the Chrome trace shows them, as host
    operators ('cpu_op'), not as user annotations, which the profiler
    mirrors onto the device's timeline."""
    root = fitted['traced'][0].trace
    events = fitted['events']
    by_name = {}
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        by_name.setdefault(name, []).append((s, e))
    (fit_ev,) = by_name['jamie.fit']
    offset = fit_ev[0] - root.start_ns
    spans = {}
    for sp in sorted(root.walk(), key=lambda sp: sp.start_ns):
        spans.setdefault('jamie.' + sp.name, []).append(sp)
    assert set(spans) == set(by_name)
    for name, group in spans.items():
        assert len(group) == len(by_name[name]), name
        for sp, (s, e) in zip(group, by_name[name]):
            assert abs(s - offset - sp.start_ns) < 1_000_000, name
            assert abs(e - offset - sp.end_ns) < 1_000_000, name
    shown = {ev['name']: ev.get('cat') for ev in fitted['chrome'][
        'traceEvents'] if str(ev.get('name')).startswith('jamie.')}
    assert set(shown) == set(spans)
    assert set(shown.values()) == {'cpu_op'}


def test_no_profiler_no_range(fitted):
    assert fitted['entered'] == 0
    assert fitted['plain'][0].trace.find('Distance')


def test_a_span_closed_after_the_profiler_stopped():
    """Opened under a profiler that stops before it closes (as the
    benchmark's traced prefix ends inside training): no error, and its
    times are kept."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with timing.span('outer') as outer:
        with timing.span('inner'):
            prof.stop()
    assert outer.seconds > 0 and outer.children[0].seconds > 0
    assert timing.current() is None


def test_recent_fits_is_bounded():
    for _ in range(timing.FITS_KEPT + 5):
        with timing.span('fit', fit=True):
            with timing.span('Distance'):
                pass
    fits = timing.recent_fits()
    assert len(fits) == timing.FITS_KEPT
    ids = [f.fit_id for f in fits]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    # a fit's spans share its id; spans outside a fit have none
    assert fits[-1].children[0].fit_id == fits[-1].fit_id
    with timing.span('alone') as alone:
        pass
    assert alone.fit_id is None and timing.recent_fits()[-1] is fits[-1]


def test_counters_and_notes():
    with timing.span('a', rows=3) as a:
        a.add('n')
        a.add('n', 2)
        with timing.span('b') as b:
            timing.note(route='x')
        a.set(k=5)
    timing.note(route='nowhere')     # no open span: ignored
    assert a.counters == {'rows': 3, 'n': 3, 'k': 5}
    assert b.counters == {'route': 'x'}
    assert a.find('b') == [b] and a.child('b') is b and a.child('c') is None
    assert timing.device_begin() is None    # no open span


def _reference_lines(history, memory=None):
    """TimeLogger.aggregate's output for the given seconds (and
    tracemalloc pairs)."""
    tl = timing.TimeLogger(memory_usage=memory is not None)
    tl.history = {k: [v] for k, v in history.items()}
    if memory is not None:
        tl.history_mem = {k: [m] for k, m in memory.items()}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        total = tl.aggregate()
    tl.stop()
    return out.getvalue(), total


@pytest.mark.parametrize('memory', [False, True])
def test_console_report_is_timeloggers(memory):
    """The estimator's report: TimeLogger.aggregate's lines, from a fit's
    phase spans, with the memory lines under enable_memory_logging."""
    jm, out, _, _ = _fit('euclidean', enable_memory_logging=memory)
    phases = [jm.trace.child(n) for n in PHASES]
    mem = ({sp.name: sp.counters['host_memory'] for sp in phases}
           if memory else None)
    want, total = _reference_lines({sp.name: sp.seconds for sp in phases},
                                   mem)
    got = out.split('JAMIE Done!\n', 1)[1]
    assert got == want + '\n'
    assert total == pytest.approx(sum(sp.seconds for sp in phases))
    assert ('Memory: Stored' in got) is memory


def test_debug_prints_the_mapping_phases():
    jm, out, _, _ = _fit('euclidean', debug=True)
    mapping = jm.trace.child('Mapping')
    want, _ = _reference_lines({sp.name: sp.seconds
                                for sp in mapping.children})
    assert want in out


def test_landmark_route_spans():
    """The landmark solver's stages are spans under Correspondence, and
    its progress line reads them."""
    jm, out, _, _ = _fit('euclidean', corr_landmarks=24)
    corr = jm.trace.child('Correspondence')
    stages = [c.name for c in corr.children]
    assert stages[:4] == ['landmark.selection', 'landmark.distances',
                          'landmark.solve', 'landmark.weights']
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith('landmark correspondence seconds: ')]
    want = ', '.join(f'{c.name.split(".")[1]} {c.seconds:.3f}'
                     for c in corr.children[:4])
    assert line == 'landmark correspondence seconds: ' + want
    assert corr.child('landmark.solve').find('prime_dual.replay')


def test_tsne_route_has_its_phases():
    jm, out, _, _ = _fit('euclidean', project_mode='tsne', tsne_iters=20)
    assert [c.name for c in jm.trace.children] == list(PHASES)
    assert not hasattr(jm, 'phase_timings')
    assert 'Total: ' in out


def test_device_time_needs_a_card():
    """On the CPU a device-timed span takes no events."""
    with timing.span('x', device=True) as sp:
        assert timing.device_begin() is None
        sp.device_end()
    assert sp.device_s is None
    assert torch.cuda.is_initialized() is False


def _csr_arms(n=80, seed=0):
    """Two CSR arms with the same cells: each column's top fifth of a
    rank-4 signal kept, the rest 0."""
    import scipy.sparse as ss
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 4)
    arms = []
    for w in (30, 50):
        x = (z @ rng.randn(4, w) + 0.1 * rng.randn(n, w)).astype(np.float32)
        x[x < np.quantile(x, 0.8, axis=0)] = 0.0
        arms.append(ss.csr_matrix(x))
    return arms


def test_landmark_and_csr_spans_carry_their_counters(monkeypatch):
    """A CSR fit on the landmark route, its FPS on the JL sketch: the four
    `landmark.*` spans name their routes and sizes, each CSR arm's device
    copy is one `residency.csr` span, and each SpMM adds its sizes to the
    span it runs in."""
    from jamie_tpu_torch.solvers import landmark
    monkeypatch.setattr(landmark, '_FPS_BYTES_BUDGET', 0)
    arms = _csr_arms()
    jm = JAMIE(device='cpu', distance_mode='geodesic', corr_landmarks=24,
               **KW)
    with contextlib.redirect_stdout(io.StringIO()):
        jm.fit_transform(dataset=arms)
    corr = jm.trace.child('Correspondence')
    sel, dist, solve, weights = (corr.child(f'landmark.{s}') for s in (
        'selection', 'distances', 'solve', 'weights'))
    assert {k: sel.counters[k] for k in ('L', 'rows', 'route')} == {
        'L': [24, 24], 'rows': [80, 80],
        'route': ['fps_jl_sketch', 'fps_jl_sketch']}
    assert dist.counters == {'mode': 'geodesic', 'L': [24, 24],
                             'features': [a.shape[1] for a in arms]}
    assert [b.counters.get('route') for b in dist.find('distances.base')
            ] == ['k3', 'k3']
    assert solve.counters == {'shape': [24, 24], 'state_dtype': 'float32',
                              'iterations': KW['epoch_pd']}
    assert {k: weights.counters[k] for k in ('layout', 'route', 'nnz',
                                              'blocks')} == {
        'layout': 'dense', 'route': ['weights_spmm', 'weights_spmm'],
        'nnz': [a.nnz for a in arms], 'blocks': 2}
    # each arm uploaded once, by the selection's sketch
    builds = jm.trace.find('residency.csr')
    assert [b.parent for b in builds] == [sel, sel]
    for b, a in zip(builds, arms):
        assert b.counters['nnz'] == a.nnz
        assert b.counters['bytes'] == 4 * (a.shape[0] + 1) + 8 * a.nnz
        assert b.counters['copy_s'] >= 0
    # the sketch's SpMMs, then each arm's landmark Gram and row norms
    assert sel.counters['spmm'] == [[a.nnz, 256, a.shape[1], a.shape[0]]
                                    for a in arms]
    assert weights.counters['spmm'] == [
        c for a in arms for c in ([a.nnz, 24, a.shape[1], a.shape[0]],
                                  [a.nnz, 1, a.shape[1], a.shape[0]])]
