"""The readers of the program's spans (`spans.py`, `metrics/<name>.py`)
on hand-built recorders: the expected value, None where a fit has no such
span, and None where the pairing of roots and fits fails."""

import pytest
import torch

import datagen
import manifest
import run
import spans
from jamie_tpu_torch.core import timing

S = 1_000_000_000       # ns a second


def _span(name, start, end, children=(), device_s=None, **counters):
    sp = timing.Span(name, **counters)
    sp.start_ns, sp.end_ns = int(start * S), int(end * S)
    sp.children = list(children)
    for c in sp.children:
        c.parent = sp
    sp._device_s = device_s
    return sp


def _root(geodesic: bool, k: float = 1.0):
    """A fit's tree: per modality a base (with a resident build in the
    euclidean fit), the kNN graph and Dijkstra in the geodesic one; the
    solve with its capture and timed replays; training with the trainer's
    three captures and timed replays. `k` scales the host seconds."""
    dist = []
    t = 0.0
    for _ in range(2):
        build = [] if geodesic else [_span('residency.build', t, t + 0.3 * k,
                                           copy_s=0.2 * k, bytes=10)]
        dist.append(_span('distances.base', t, t + 0.4 * k, build))
        t += 0.4 * k
        if geodesic:
            dist += [_span('distances.knn_graph', t, t + 1.0 * k),
                     _span('distances.shortest_path', t + 1.0 * k,
                           t + 2.5 * k)]
            t += 2.5 * k
    distance = _span('Distance', 0.0, t + 0.01, dist)
    c0 = t + 0.01
    capture = _span('graphs.capture', c0 + 0.1, c0 + 0.2, loop='prime_dual')
    replay = _span('prime_dual.replay', c0 + 0.1, c0 + 0.5, [capture],
                   device_s=0.099, steps=100, replays=99)
    corr = _span('Correspondence', c0, c0 + 0.6, [replay])
    m0 = c0 + 0.6
    caps = [_span('graphs.capture', m0 + 0.1 * j, m0 + 0.1 * (j + 1))
            for j in range(3)]
    tcap = _span('trainer.capture', m0, m0 + 0.3, caps)
    treplay = _span('trainer.replay', m0, m0 + 3.0, [tcap], device_s=2.8,
                    epochs=200, steps=1400)
    training = _span('Training', m0, m0 + 3.1, [treplay])
    mapping = _span('Mapping', m0, m0 + 3.2, [training])
    return _span('fit', 0.0, m0 + 3.2, [distance, corr, mapping])


def _record(roots):
    return {'fits': [{'phases': {c.name: round(c.seconds, 3)
                                 for c in r.children}} for r in roots]}


EXPECTED = {
    # name: (geodesic fits, euclidean fits) for k = 1 and k = 2
    'distances.knn_graph_s': (2 * 1.5, None),
    'distances.dijkstra_s': (2 * 1.5 * 1.5, None),
    'residency.copy_s': (None, 2 * 0.2 * 1.5),
    'graphs.capture_s': (0.4, 0.4),
    'prime_dual.replay_ms_per_iter': (1.0, 1.0),
    'trainer.replay_ms_per_step': (2.0, 2.0),
}


@pytest.mark.parametrize('name', sorted(EXPECTED))
@pytest.mark.parametrize('geodesic', [True, False])
def test_reader_reads_the_spans(monkeypatch, name, geodesic):
    """Two fits (k = 1, 2) after an older one that is not in the record:
    the mean over the record's fits, or None for a fit with no such
    span."""
    roots = [_root(geodesic, k) for k in (3.0, 1.0, 2.0)]
    monkeypatch.setattr(timing, 'recent_fits', lambda: roots)
    got = manifest.reader(name)(_record(roots[1:]))
    want = EXPECTED[name][0 if geodesic else 1]
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_misaligned_pairing_reads_none(monkeypatch, name):
    """The recorder's last fits are not the record's: another fit's
    phases, or fewer roots than fits."""
    roots = [_root(True, k) for k in (1.0, 2.0)]
    monkeypatch.setattr(timing, 'recent_fits', lambda: roots)
    shifted = _record([_root(True, 3.0), roots[0]])
    assert manifest.reader(name)(shifted) is None
    monkeypatch.setattr(timing, 'recent_fits', lambda: roots[:1])
    assert manifest.reader(name)(_record(roots)) is None


def test_no_recorder_reads_none(monkeypatch):
    """A program without `recent_fits` (an older one) gives no roots."""
    monkeypatch.delattr(timing, 'recent_fits')
    assert spans.fit_roots(_record([_root(True)])) == [None]
    assert spans.mean_over_fits({'fits': []}, lambda r: 1.0) is None


def test_a_real_fit_pairs(tiny_configs):
    """A fit of the program on the CPU: its root pairs with the record
    that run.one_fit makes, and the span readers read it."""
    cfg = tiny_configs['scmnc_visual']
    traffic = manifest.traffic('geodesic')
    host = [x.numpy() for x in datagen.make_pair(cfg, 3, torch.device('cpu'))]
    rec = run.one_fit(host, run.fit_kwargs(cfg, traffic, 3),
                      torch.device('cpu'), keep=False)
    record = {'fits': [rec]}
    (root,) = spans.fit_roots(record)
    assert root is timing.recent_fits()[-1]
    knn = manifest.reader('distances.knn_graph_s')(record)
    dij = manifest.reader('distances.dijkstra_s')(record)
    assert 0 < knn + dij <= rec['phases']['Distance'] + 1e-3
    assert manifest.reader('graphs.capture_s')(record) is None   # the CPU
    assert manifest.reader('prime_dual.replay_ms_per_iter')(record) is None


def test_manifest_stays_clean(bench):
    assert manifest.problems(bench) == []
