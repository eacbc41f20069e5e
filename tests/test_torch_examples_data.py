"""The real-data example twins of `jamie_tpu_torch.examples` (scgem,
comparison, the scGEM arm of imputation_comparison, scmnc_motor and its
sweep, motor_provenance_fingerprint, scmnc_visual, scglue) against the
repo's `examples/`, on small fixture files written under tmp_path in the
datasets' formats (a JAX example is pointed at them through its `DATA`):

- each loader against the example's on the same files: bit-equal, but
  for a sweep candidate (the port's `normalize` functions order their
  float64 arithmetic differently from the sweep's inline copies) and the
  fingerprint's distance matrices (float32 K3 and the port's geodesic
  against sklearn's float64 and jamie_tpu's), each within its stated
  tolerance; `_data.scale` against sklearn's `preprocessing.scale` bit for
  bit;
- each `main` (and the multi-seed, ablation and imputation functions)
  with a recording stub in place of `JAMIE` (and of `compare_methods`,
  `predict_knn`, `predict_nn` and `solver_trace` where the example calls
  them) on both sides: the same constructor kwargs, datasets, P masks,
  splits and call order, and the same record but for its seconds;
- `reference_js_distance_mean`, `_imputation_metrics` and `score` on
  seeded inputs, and `solver_trace` on a tiny pair;
- each twin's `main` for real on the CPU at <= 80 cells and <= 20 epochs:
  the example's record keys and finite values.

No JAX fit runs here (the fingerprint's solver replays run jamie_tpu's
prime-dual)."""

import csv
import importlib
import json
import pathlib
import sys
import warnings

import numpy as np
import pytest

import jamie_tpu
import jamie_tpu_torch
from jamie_tpu_torch.examples import (_data, comparison,
                                      imputation_comparison,
                                      motor_provenance_fingerprint,
                                      scglue, scgem, scmnc_motor,
                                      scmnc_motor_sweep, scmnc_visual)
from rda_xdr import write_motor_rda

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMES = ('fit_seconds', 'total_seconds', 'seconds', 'baseline_seconds')
FAMILIES = ('Sst Chodl', 'Pvalb Reln', 'L5 IT')


def _example(name):
    path = str(ROOT / 'examples')
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _cells(rng, n, dims, counts=(False, False)):
    """Two modalities of n cells from one 4-dimensional latent around three
    type centres; a count modality is Poisson around its exponent."""
    labels = rng.choice(3, n, p=(0.5, 0.3, 0.2))
    z = 2.0 * rng.randn(3, 4)[labels] + rng.randn(n, 4)
    out = []
    for f, is_count in zip(dims, counts):
        x = z @ rng.randn(4, f) / 2.0
        out.append(rng.poisson(np.exp(np.clip(0.5 * x, -3, 3))).astype(
            np.float64) if is_count else x + 0.5 * rng.randn(n, f))
    return out, labels


def write_scgem(d, n=60, dims=(23, 9), seed=0):
    (x1, x2), labels = _cells(np.random.RandomState(seed), n, dims)
    np.savetxt(d / 'GeneExpression.txt', x1, '%.6g')
    np.savetxt(d / 'DNAmethylation.txt', x2, '%.6g')
    for name in ('type1.txt', 'type2.txt'):
        np.savetxt(d / name, labels + 1, '%d')
    return d


def write_motor(d, n=60, dims=(40, 6), seed=1):
    rng = np.random.RandomState(seed)
    (x1, x2), labels = _cells(rng, n, dims, counts=(True, False))
    x2[3, 1] = x2[7, 4] = np.nan
    cells = [f'c{i}' for i in range(n)]
    write_motor_rda(str(d / 'motor_data_filtered.rda'), x1.T, x2,
                    [f'ef {j}' for j in range(dims[1])], cells,
                    [FAMILIES[t] for t in labels],
                    meta_order=rng.permutation(n))
    return d


def write_visual(d, n=60, dims=(30, 7), seed=2):
    rng = np.random.RandomState(seed)
    (x1, x2), labels = _cells(rng, n, dims, counts=(True, False))
    samples = [f'SM-{i}_x' for i in range(n)]
    with open(d / 'geneExp_filtered.csv', 'w', newline='') as fh:
        w = csv.writer(fh)
        w.writerow([''] + samples)
        for j in range(dims[0]):
            w.writerow([f'g{j}'] + x1[:, j].astype(int).tolist())
    with open(d / 'efeature_filtered.csv', 'w', newline='') as fh:
        w = csv.writer(fh)
        w.writerow(['sample', 'id', 'layer'] + [f'e{j}'
                                                 for j in range(dims[1])])
        for i in range(n):
            w.writerow([samples[i], i, 'L4'] + [
                'NA' if (i, j) in ((2, 3), (9, 0)) else f'{x2[i, j]:.6g}'
                for j in range(dims[1])])
    with open(d / '20200711_patchseq_metadata_mouse.csv', 'w',
              newline='') as fh:
        w = csv.writer(fh)
        w.writerow(['project', 'transcriptomics_sample_id', 't_type'])
        for i in rng.permutation(n):
            w.writerow(['p', samples[i], FAMILIES[labels[i]]])
    return d


def write_scglue(d, n=60, dims=(30, 50), seed=3):
    pytest.importorskip('h5py')
    from test_torch_io import _make_h5ad
    (x1, x2), labels = _cells(np.random.RandomState(seed), n, dims)
    types = [FAMILIES[t] for t in labels]
    _make_h5ad(str(d / 'Chen-2019-RNA.h5ad'), x1.astype(np.float32),
               cell_types=types)
    _make_h5ad(str(d / 'Chen-2019-ATAC.h5ad'), (x2 > 0.5).astype(np.float32),
               fmt='csr', cell_types=types)
    return d


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """A writer's directory, the JAX example modules' DATA pointed at it."""
    def make(writer, *modules, **kw):
        d = tmp_path / writer.__name__
        d.mkdir(exist_ok=True)
        writer(d, **kw)
        for m in modules:
            monkeypatch.setattr(_example(m), 'DATA', str(d) + '/')
        return str(d)
    return make


def _same(a, b, path=''):
    """a == b over nested dicts, lists and arrays, exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.dtype,
                                                            b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------- the loaders
@pytest.mark.parametrize('case', [
    dict(seed=0, nan=False, const=False), dict(seed=1, nan=True, const=True),
    dict(seed=2, nan=True, const=False, big=1e9)])
def test_scale_matches_sklearn(case):
    preprocessing = pytest.importorskip('sklearn.preprocessing')
    rng = np.random.RandomState(case['seed'])
    x = rng.randn(40, 6) * 3 + case.get('big', 0.0)
    if case['nan']:
        x[[1, 5, 7], [0, 2, 2]] = np.nan
    if case['const']:
        x[:, 3] = 2.5
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # sklearn's numerical warnings
        ref = preprocessing.scale(x, axis=0)
    got = _data.scale(x)
    np.testing.assert_array_equal(got, ref)
    assert not np.shares_memory(got, x)


def test_load_scgem_equal(data_dir):
    d = data_dir(write_scgem, 'scgem')
    _same(scgem.load_scgem(d), _example('scgem').load_scgem())


def test_load_scmnc_motor_equal(data_dir):
    d = data_dir(write_motor, 'scmnc_motor')
    _same(scmnc_motor.load_scmnc_motor(data_dir=d),
          _example('scmnc_motor').load_scmnc_motor())


@pytest.mark.parametrize('name', ['logcpm_1e4', 'tmm_log', 'pearson_resid'])
def test_load_scmnc_motor_sweep_candidate(data_dir, name):
    """A sweep candidate through both loaders: float32 z-scores within
    1e-6 (the port's normalize functions differ from the inline copies in
    the order of their float64 operations); the labels equal."""
    d = data_dir(write_motor, 'scmnc_motor')
    ours, our_types = scmnc_motor.load_scmnc_motor(
        normalize=scmnc_motor_sweep.CANDIDATES[name], data_dir=d)
    ref, ref_types = _example('scmnc_motor').load_scmnc_motor(
        normalize=_example('scmnc_motor_sweep').CANDIDATES[name])
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    _same(our_types, ref_types)
    assert list(scmnc_motor_sweep.CANDIDATES) == list(
        _example('scmnc_motor_sweep').CANDIDATES)


def test_fingerprint_load_raw_and_candidates_equal(data_dir):
    d = data_dir(write_motor, 'motor_provenance_fingerprint')
    jfp = _example('motor_provenance_fingerprint')
    X, E = motor_provenance_fingerprint.load_raw(d)
    _same((X, E), jfp.load_raw())
    ours, ref = motor_provenance_fingerprint.candidates(), jfp.candidates()
    assert list(ours) == list(ref)
    for name in ours:
        _same(ours[name](X.copy()), ref[name](X.copy()), name)


def test_load_scmnc_visual_equal(data_dir):
    pytest.importorskip('pandas')
    d = data_dir(write_visual, 'scmnc_visual')
    _same(scmnc_visual.load_scmnc_visual(d),
          _example('scmnc_visual').load_scmnc_visual())


def test_load_scglue_equal(data_dir):
    d = data_dir(write_scglue, 'scglue')
    _same(scglue.load_scglue(d), _example('scglue').load_scglue())


@pytest.mark.parametrize('name', ['scgem', 'scmnc_motor', 'scmnc_visual',
                                  'scglue'])
def test_missing_data_exits_zero(tmp_path, capsys, name):
    """As the examples do: no data, a message and exit code 0."""
    loader = {'scgem': scgem.load_scgem,
              'scmnc_motor': lambda d: scmnc_motor.load_scmnc_motor(
                  data_dir=d),
              'scmnc_visual': scmnc_visual.load_scmnc_visual,
              'scglue': scglue.load_scglue}[name]
    with pytest.raises(SystemExit) as e:
        loader(str(tmp_path / 'absent'))
    assert e.value.code == 0 and 'not found' in capsys.readouterr().out


@pytest.mark.parametrize('writer', ['write_scgem', 'write_motor_rda',
                                    'write_visual_csv'])
def test_chip_smoke_fixture_files_load_alike(tmp_path, monkeypatch, writer):
    """chip_smoke.py's synthetic files of phase R, at a small size, read
    the same through both packages' loaders."""
    import chip_smoke
    module, ours = {
        'write_scgem': ('scgem', scgem.load_scgem),
        'write_motor_rda': ('scmnc_motor', lambda d: (
            scmnc_motor.load_scmnc_motor(data_dir=d))),
        'write_visual_csv': ('scmnc_visual', scmnc_visual.load_scmnc_visual),
    }[writer]
    if module == 'scmnc_visual':
        pytest.importorskip('pandas')
    getattr(chip_smoke, writer)(str(tmp_path), np.random.RandomState(0),
                                n=50, dims=(20, 5))
    monkeypatch.setattr(_example(module), 'DATA', str(tmp_path) + '/')
    ref = getattr(_example(module), 'load_' + module)()
    _same(ours(str(tmp_path)), ref)
    assert ref[0][0].shape == (50, 20) and ref[0][1].shape == (50, 5)


# ----------------------------------------------- the mains, JAMIE stubbed
class Recorder:
    """Stand-ins for JAMIE and the baselines that log every call. Their
    outputs are deterministic functions of the inputs, the same on both
    sides."""

    def __init__(self):
        self.log = []

    def jamie(self):
        rec = self

        class Stub:
            def __init__(self, **kwargs):
                kwargs.pop('device', None)
                rec.log.append(('JAMIE', kwargs))
                self.epochs_run = 7

            def fit_transform(self, dataset=None, P=None):
                rec.log.append(('fit_transform', list(dataset), P))
                self.dims = [d.shape[1] for d in dataset]
                return self.transform(dataset)

            def transform(self, dataset=None):
                rec.log.append(('transform', list(dataset)))
                return [np.asarray(d, np.float64)[:, :2] for d in dataset]

            def test_closer(self, emb):
                return float(np.abs(emb[0] - emb[1]).mean() / 100)

            def test_LabelTA(self, emb, types):
                rec.log.append(('test_LabelTA', list(types)))
                return float(np.tanh(np.abs(emb[0]).mean()))

            def modal_predict(self, x, modality):
                out = self.dims[1 - modality]
                w = np.random.RandomState(modality).randn(x.shape[1], out)
                return np.tanh(np.asarray(x, np.float64) @ w / 3)
        return Stub

    def compare_methods(self, dataset, labels, methods, output_dim,
                        method_kwargs, device=None):
        self.log.append(('compare_methods', list(dataset), list(labels),
                         methods, output_dim, method_kwargs))
        return {m: {'embeddings': None, 'foscttm': 0.125 + i / 100,
                    'lta': 0.5 + i / 10} for i, m in enumerate(methods)}

    def predict(self, tag):
        def fn(source, target, val=None, device=None, **kw):
            self.log.append((tag, source, target, val, kw))
            w = np.random.RandomState(target.shape[1]).randn(
                val.shape[1], target.shape[1])
            return np.tanh(val @ w / 5)
        return fn

    def solver_trace(self, Kx, Ky, dx, dy, precision, device=None):
        self.log.append(('solver_trace', np.asarray(Kx), np.asarray(Ky), dx,
                         dy, precision))
        return {500: (0.4, 0.005), 1000: (3.0, 0.02), 1500: (5.0, 0.06),
                2000: (float(np.asarray(Kx).mean()), 0.09)}


def _stubbed(monkeypatch):
    """(recorder for jamie_tpu, recorder for the port), with JAMIE,
    compare_methods, predict_knn and predict_nn replaced in both."""
    import jamie_tpu.compare
    import jamie_tpu.models.baselines
    import jamie_tpu.utils
    import jamie_tpu_torch.compare
    import jamie_tpu_torch.models.baselines
    import jamie_tpu_torch.utils
    recs = Recorder(), Recorder()
    for rec, pkg, comp, base, utils in (
            (recs[0], jamie_tpu, jamie_tpu.compare,
             jamie_tpu.models.baselines, jamie_tpu.utils),
            (recs[1], jamie_tpu_torch, jamie_tpu_torch.compare,
             jamie_tpu_torch.models.baselines, jamie_tpu_torch.utils)):
        monkeypatch.setattr(pkg, 'JAMIE', rec.jamie())
        monkeypatch.setattr(comp, 'compare_methods', rec.compare_methods)
        monkeypatch.setattr(base, 'predict_nn', rec.predict('predict_nn'))
        monkeypatch.setattr(utils, 'predict_knn', rec.predict('predict_knn'))
    return recs


def _no_times(rec):
    if isinstance(rec, dict):
        return {k: _no_times(v) for k, v in rec.items() if k not in TIMES}
    return rec


def _held(recs, ours, ref):
    """The call logs equal (kwargs, datasets, P masks, splits, order) and
    the records equal but for their seconds."""
    assert recs[0].log, 'the stub saw no call'
    _same(recs[1].log, recs[0].log)
    _same(_no_times(ours), _no_times(ref))


SCGEM_RUNS = {
    'main': (lambda m, d: m.main(data_dir=d, device='cpu'),
             lambda m: m.main()),
    'main quick': (lambda m, d: m.main(quick=True, data_dir=d, device='cpu'),
                   lambda m: m.main(quick=True)),
    'multi_seed': (lambda m, d: m.multi_seed(2, data_dir=d, device='cpu'),
                   lambda m: m.multi_seed(2)),
    'imputation_multi_seed': (
        lambda m, d: m.imputation_multi_seed(2, data_dir=d, device='cpu'),
        lambda m: m.imputation_multi_seed(2)),
    'imputation reference_split': (
        lambda m, d: m.imputation_multi_seed(
            2, quick=True, reference_split=True, data_dir=d, device='cpu'),
        lambda m: m.imputation_multi_seed(2, quick=True,
                                          reference_split=True)),
    'ablation': (lambda m, d: m.ablation(1, data_dir=d, device='cpu'),
                 lambda m: m.ablation(1)),
}


@pytest.mark.parametrize('run', list(SCGEM_RUNS))
def test_scgem_calls_as_example(monkeypatch, data_dir, run):
    d = data_dir(write_scgem, 'scgem')
    recs = _stubbed(monkeypatch)
    ours_fn, ref_fn = SCGEM_RUNS[run]
    ref = ref_fn(_example('scgem'))
    ours = ours_fn(scgem, d)
    _held(recs, ours, ref)


@pytest.mark.parametrize('quick', [False, True])
def test_comparison_calls_as_example(monkeypatch, data_dir, quick):
    d = data_dir(write_scgem, 'scgem')
    recs = _stubbed(monkeypatch)
    ref = _example('comparison').main(quick=quick)
    ours = comparison.main(quick=quick, data_dir=d, device='cpu')
    _held(recs, ours, ref)
    assert comparison.REFERENCE == _example('comparison').REFERENCE


@pytest.mark.parametrize('quick', [False, True])
def test_imputation_scgem_arm_calls_as_example(monkeypatch, data_dir, quick):
    d = data_dir(write_scgem, 'scgem')
    recs = _stubbed(monkeypatch)
    ref = _example('imputation_comparison').scgem_multi_seed(2, quick=quick)
    ours = imputation_comparison.scgem_multi_seed(2, quick=quick, data_dir=d,
                                                  device='cpu')
    _held(recs, ours, ref)


@pytest.mark.parametrize('kw', [dict(), dict(partial=True),
                                dict(quick=True, partial=True)])
def test_scmnc_motor_calls_as_example(monkeypatch, data_dir, kw):
    d = data_dir(write_motor, 'scmnc_motor')
    recs = _stubbed(monkeypatch)
    ref = _example('scmnc_motor').main(**kw)
    ours = scmnc_motor.main(data_dir=d, device='cpu', **kw)
    _held(recs, ours, ref)


def test_scmnc_motor_multi_seed_calls_as_example(monkeypatch, data_dir):
    d = data_dir(write_motor, 'scmnc_motor')
    recs = _stubbed(monkeypatch)
    ref = _example('scmnc_motor').multi_seed(2, quick=True)
    ours = scmnc_motor.multi_seed(2, quick=True, data_dir=d, device='cpu')
    _held(recs, ours, ref)


def test_sweep_calls_as_example(monkeypatch, data_dir, capsys):
    """Two candidates, two seeds: the same fits in the same order; the
    datasets within the sweep loader's tolerance."""
    d = data_dir(write_motor, 'scmnc_motor')
    recs = _stubbed(monkeypatch)
    monkeypatch.setattr(sys, 'argv', ['sweep', '--seeds', '2', '--only',
                                      'raw,logcpm_median'])
    _example('scmnc_motor_sweep').main()
    ref = json.loads(capsys.readouterr().out.split('\n\n')[-1])
    ours = scmnc_motor_sweep.main(['--seeds', '2', '--only',
                                   'raw,logcpm_median', '--data-dir', d,
                                   '--device', 'cpu'])
    assert [e[0] for e in recs[1].log] == [e[0] for e in recs[0].log]
    for a, b in zip(recs[1].log, recs[0].log):
        if a[0] == 'JAMIE':
            _same(a[1], b[1])
        elif a[0] in ('fit_transform', 'transform'):
            for x, y in zip(a[1], b[1]):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    assert set(ours) == set(ref) and set(ours['sweep']) == set(ref['sweep'])
    for name in ref['sweep']:
        assert set(ours['sweep'][name]) == set(ref['sweep'][name])


@pytest.mark.parametrize('argv', [
    ['--confirm', 'cpm1e4_log1p'],
    ['--distance', 'euclidean'],
    ['--confirm', 'pearson_theta10', '--distance', 'euclidean'],
], ids=['confirm-geodesic', 'zoo-euclidean', 'confirm-euclidean'])
def test_fingerprint_calls_as_example(monkeypatch, data_dir, capsys, argv):
    """The same candidates in order, each solver replay given distance
    matrices within 1e-4 of the largest entry (K3 in float32 and the
    port's geodesic against sklearn's float64 euclidean and jamie_tpu's
    geodesic), the same dims and precision; the printed ranking lines
    alike."""
    d = data_dir(write_motor, 'motor_provenance_fingerprint')
    jfp = _example('motor_provenance_fingerprint')
    recs = Recorder(), Recorder()
    monkeypatch.setattr(jfp, 'solver_trace', recs[0].solver_trace)
    monkeypatch.setattr(motor_provenance_fingerprint, 'solver_trace',
                        recs[1].solver_trace)
    monkeypatch.setattr(sys, 'argv', ['fingerprint', *argv])
    jfp.main()
    ref_lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    ours = motor_provenance_fingerprint.main([*argv, '--data-dir', d,
                                              '--device', 'cpu'])
    our_lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(recs[1].log) == len(recs[0].log) == len(ref_lines) - 1
    for a, b in zip(recs[1].log, recs[0].log):
        for x, y in zip(a[1:3], b[1:3]):
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-4 * np.abs(y).max())
        assert a[3:] == b[3:]
    assert [x.keys() for x in our_lines] == [x.keys() for x in ref_lines]
    assert [x['candidate'] for x in our_lines[:-1]] == [
        x['candidate'] for x in ref_lines[:-1]]
    assert ours['ranking'] == our_lines[-1]['ranking']
    assert json.loads(json.dumps(ours['candidates'])) == our_lines[:-1]
    assert ours['ref_trace'] == {k: list(v) for k, v in jfp.REF_TRACE.items()}


@pytest.mark.parametrize('kw', [dict(), dict(partial=True)])
def test_scmnc_visual_calls_as_example(monkeypatch, data_dir, kw):
    pytest.importorskip('pandas')
    d = data_dir(write_visual, 'scmnc_visual')
    recs = _stubbed(monkeypatch)
    ref = _example('scmnc_visual').main(**kw)
    ours = scmnc_visual.main(data_dir=d, device='cpu', **kw)
    _held(recs, ours, ref)


@pytest.mark.parametrize('quick', [False, True])
def test_scglue_calls_as_example(monkeypatch, data_dir, quick):
    d = data_dir(write_scglue, 'scglue')
    recs = _stubbed(monkeypatch)
    ref = _example('scglue').main(quick=quick)
    ours = scglue.main(quick=quick, data_dir=d, device='cpu')
    _held(recs, ours, ref)
    # run on arrays is main without the loader
    recs[1].log = []
    again = scglue.run(*scglue.load_scglue(d), quick=quick, device='cpu')
    _held(recs, again, ref)


# ------------------------------------------------- the metric functions
def test_reference_js_distance_mean_equal():
    rng = np.random.RandomState(0)
    true, pred = rng.randn(50, 6), rng.randn(50, 6) * 1.3 + 0.2
    labs = rng.choice(['a', 'b', 'c'], 50)
    true[labs == 'b', 2] = 1.0         # a constant column inside a label
    order = np.array(['a', 'b', 'c', 'd'])   # 'd' absent: counted as 0
    ref = _example('scgem').reference_js_distance_mean(true, pred, labs,
                                                       order)
    assert scgem.reference_js_distance_mean(true, pred, labs, order) == ref


def test_imputation_metrics_equal():
    rng = np.random.RandomState(1)
    dataset = [rng.randn(40, 5).astype(np.float32),
               rng.randn(40, 3).astype(np.float32)]
    types = [rng.randint(0, 3, 40), rng.randint(0, 3, 40)]
    test_idx = np.arange(0, 40, 4)

    class Model:
        def modal_predict(self, x, modality):
            w = np.random.RandomState(modality).randn(x.shape[1],
                                                      (3, 5)[modality])
            return np.tanh(x @ w)
    _same(scgem._imputation_metrics(Model(), dataset, types, test_idx),
          _example('scgem')._imputation_metrics(Model(), dataset, types,
                                                test_idx))


@pytest.mark.parametrize('trace', [
    {500: (0.39, 0.0051), 1000: (3.3, 0.025), 1500: (5.8, 0.06),
     2000: (7.0, 0.09)},
    {500: (0.3861, 0.005), 1000: (3.3359, 0.0249)},
    {}])
def test_score_equal(trace):
    assert motor_provenance_fingerprint.score(trace) == _example(
        'motor_provenance_fingerprint').score(trace)
    assert motor_provenance_fingerprint.REF_TRACE == _example(
        'motor_provenance_fingerprint').REF_TRACE


def test_solver_trace_on_a_tiny_pair():
    """The port's prime_dual printed lines parse to the same four epochs
    as jamie_tpu's, err and alpha within tests/test_torch_prime_dual.py's
    float32 tolerance (2e-5 relative) and the printed 4 decimals."""
    rng = np.random.RandomState(0)
    x, y = rng.rand(24, 5), rng.rand(24, 3)
    Kx = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32)
    Ky = np.sqrt(((y[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
    ref = _example('motor_provenance_fingerprint').solver_trace(
        Kx, Ky, 5, 3, 'highest')
    ours = motor_provenance_fingerprint.solver_trace(Kx, Ky, 5, 3, 'highest',
                                                     device='cpu')
    assert sorted(ours) == sorted(ref) == [500, 1000, 1500, 2000]
    for ep in ref:
        for a, b in zip(ours[ep], ref[ep]):
            assert abs(a - b) <= 2e-5 * abs(b) + 1e-4, (ep, ours, ref)


# --------------------------------------------------- the mains for real
def _keys(rec):
    return {k: (_keys(v) if isinstance(v, dict) else None)
            for k, v in rec.items()}


def _finite(rec):
    """Every number in the record (strings aside) is finite."""
    if isinstance(rec, dict):
        rec = list(rec.values())
    if isinstance(rec, (list, tuple)):
        for v in rec:
            _finite(v)
    elif not isinstance(rec, str):
        assert np.isfinite(rec), rec


CUTS = dict(epoch_DNN=20, min_epochs=10, epoch_pd=30)


def _stub_keys(monkeypatch, fn):
    """The example's record keys, from its run with everything stubbed."""
    with monkeypatch.context() as m:
        _stubbed(m)
        return _keys(fn())


@pytest.mark.parametrize('name', ['scgem', 'comparison', 'imputation'])
def test_scgem_mains_tiny(monkeypatch, data_dir, name):
    d = data_dir(write_scgem, 'scgem', n=70)
    ref_fn, ours_fn = {
        'scgem': (lambda: _example('scgem').main(),
                  lambda: scgem.main(data_dir=d, device='cpu', cuts=CUTS)),
        'comparison': (lambda: _example('comparison').main(quick=True),
                       lambda: comparison.main(quick=True, data_dir=d,
                                               device='cpu', cuts=CUTS)),
        'imputation': (
            lambda: _example('imputation_comparison').scgem_multi_seed(1),
            lambda: imputation_comparison.scgem_multi_seed(
                1, data_dir=d, device='cpu', cuts=CUTS)),
    }[name]
    keys = _stub_keys(monkeypatch, ref_fn)
    if name == 'comparison':
        # the baselines' UnionCom and MMD-MA cut further on the CPU
        from jamie_tpu_torch import compare
        real = compare.compare_methods

        def cut(*a, method_kwargs=None, **k):
            method_kwargs['MMD-MA']['n_iters'] = 21
            method_kwargs['UnionCom'].update(epoch_pd=30, tsne_iters=20)
            return real(*a, method_kwargs=method_kwargs, **k)
        monkeypatch.setattr(compare, 'compare_methods', cut)
    rec = ours_fn()
    assert _keys(rec) == keys
    _finite(rec)


@pytest.mark.parametrize('name', ['scmnc_motor', 'sweep', 'fingerprint',
                                  'scmnc_visual', 'scglue'])
def test_other_mains_tiny(monkeypatch, data_dir, capsys, name):
    if name == 'scmnc_visual':
        pytest.importorskip('pandas')
    writer, module = {'scmnc_motor': (write_motor, 'scmnc_motor'),
                      'sweep': (write_motor, 'scmnc_motor'),
                      'fingerprint': (write_motor,
                                      'motor_provenance_fingerprint'),
                      'scmnc_visual': (write_visual, 'scmnc_visual'),
                      'scglue': (write_scglue, 'scglue')}[name]
    d = data_dir(writer, module)
    cuts = ['--epoch-dnn', '20', '--min-epochs', '10', '--epoch-pd', '30']
    if name == 'sweep':
        args = ['--seeds', '1', '--only', 'logcpm_1e4']
        monkeypatch.setattr(sys, 'argv', ['sweep', *args])
        with monkeypatch.context() as m:
            _stubbed(m)
            _example('scmnc_motor_sweep').main()
        keys = _keys(json.loads(capsys.readouterr().out.split('\n\n')[-1]))
        rec = scmnc_motor_sweep.main([*args, '--data-dir', d,
                                      '--device', 'cpu', *cuts])
        keys['sweep'] = {'logcpm_1e4': keys['sweep']['logcpm_1e4']}
    elif name == 'fingerprint':
        rec = motor_provenance_fingerprint.main(
            ['--confirm', 'cpm1e4_log1p', '--data-dir', d, '--device', 'cpu'])
        keys = {'candidates': None, 'ranking': None, 'ref_trace': _keys(
            {k: 0 for k in motor_provenance_fingerprint.REF_TRACE})}
        assert sorted(rec['candidates'][0]['trace']) == [500, 1000, 1500,
                                                         2000]
    else:
        mod = {'scmnc_motor': scmnc_motor, 'scmnc_visual': scmnc_visual,
               'scglue': scglue}[name]
        kw = {} if name == 'scglue' else dict(partial=True)
        keys = _stub_keys(monkeypatch, lambda: _example(module).main(**kw))
        rec = mod.main(data_dir=d, device='cpu', cuts=CUTS, **kw)
    assert _keys(rec) == keys
    _finite(rec)
