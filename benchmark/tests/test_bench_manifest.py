"""BENCHMARK.json's names and units, and the discovery of configurations,
cells and metrics by file name: a throwaway cell and metric, added as new
files and entries only in a copy of the tree, are run and reported."""

import json
import shutil
from pathlib import Path

import pytest

import manifest
from conftest import tiny


def test_manifest_has_no_problems(bench):
    assert manifest.problems(bench) == []
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert {m['name'] for m in bench['end_to_end']} == {
        'fit_s', 'peak_gib', 'setup_s'}
    assert all(m['moves'] == 'fit_s' for m in bench['per_layer'])


@pytest.mark.parametrize('name,ok', [
    ('fit_s', True), ('k1_roofline', True),
    ('device.idle_share_to_epoch2', True),
    ('a-b.c_9', True), ('_x', True), ('9x', True), ('.x', False),
    ('a b', False), ('a,b', False), ('a/b', False), ('µs', False),
    ('x' * 64, True), ('x' * 65, False)])
def test_names(name, ok):
    assert bool(manifest.NAME_RE.match(name)) is ok


@pytest.mark.parametrize('unit,ok', [
    ('s', True), ('%', True), ('tokens/s', True), ('GiB', True),
    ('ms', True), ('', False), ('tokens per s', False), ('µs', False),
    ('x' * 16, True), ('x' * 17, False)])
def test_units(unit, ok):
    assert bool(manifest.UNIT_RE.match(unit)) is ok


def test_bad_manifest_is_reported(bench):
    bad = json.loads(json.dumps(bench))
    bad['per_layer'].append(dict(bad['per_layer'][0], name='no reader x'))
    bad['workloads'].append(dict(bad['workloads'][0], name='x.y',
                                 config='nope'))
    found = manifest.problems(bad)
    assert any('bad name' in p for p in found)
    assert any('unknown config' in p for p in found)


def _tree(tmp_path, monkeypatch):
    """A copy of the benchmark's folder, which `manifest` then reads."""
    root = tmp_path / 'tree'
    shutil.copytree(manifest.HERE, root / 'benchmark',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    monkeypatch.setattr(manifest, 'HERE', root / 'benchmark')
    monkeypatch.setattr(manifest, 'REPO', root)
    return root, root / 'benchmark'


@pytest.mark.parametrize('name,found', [
    ('dense', None), ('no_such_route', 'no harness file'),
    ('a b', 'bad harness'), ('../dense', 'bad harness'),
    (3, 'bad harness')])
def test_harness_key_is_checked(tmp_path, bench, monkeypatch, name, found):
    root, here = _tree(tmp_path, monkeypatch)
    cfg = manifest.config(bench, 'scglue')
    cfg['harness'] = name
    (here / 'configs' / 'scglue.json').write_text(json.dumps(cfg))
    got = [p for p in manifest.problems(bench) if 'harness' in p]
    assert got == ([] if found is None else [got[0]])
    assert found is None or found in got[0]


def test_harness_defaults_to_dense(bench):
    cfg = manifest.config(bench, 'scglue')
    assert 'harness' not in cfg
    module = manifest.harness(cfg)
    assert Path(module.__file__) == manifest.HERE / 'harness' / 'dense.py'
    assert all(callable(getattr(module, k)) for k in (
        'make_host', 'produced', 'solve', 'Reference'))


def test_new_cell_and_metric_are_files_only(tmp_path, bench, monkeypatch):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and BENCHMARK.json entries in a copy of the tree, with
    no file of the harness edited, run and report."""
    root, here = _tree(tmp_path, monkeypatch)
    cfg = tiny(manifest.config(bench, 'scmnc_visual'))
    cfg['name'] = 'toy'
    (here / 'configs' / 'toy.json').write_text(json.dumps(cfg))
    traffic = manifest.traffic('euclidean')
    traffic['kwargs']['distance_mode'] = 'euclidean'
    (here / 'traffic' / 'toy_mix.json').write_text(json.dumps(traffic))
    (here / 'workloads' / 'toy.toy_mix.json').write_text(json.dumps(
        {'limits': {'dist': 1e-3, 'f': 1e-2, 'pca': 1e-3, 'embed': 1e-4,
                    'foscttm': 0.9}}))
    (here / 'metrics' / 'toy.fits.py').write_text(
        'def read(rec):\n    return float(len(rec["fits"]))\n')
    new = json.loads(json.dumps(bench))
    new['configs'].append({'name': 'toy', 'source': 'a test',
                           'file': 'benchmark/configs/toy.json',
                           'reduced': [], 'why': 'a test'})
    new['workloads'].append({'name': 'toy.toy_mix', 'config': 'toy',
                             'traffic': 'toy_mix', 'chips': 1,
                             'why': 'a test'})
    new['per_layer'].append({'name': 'toy.fits', 'unit': '1',
                             'better': 'higher', 'source': 'host_clock',
                             'layer': 'test', 'moves': 'fit_s',
                             'workloads': ['toy.toy_mix']})
    (root / 'BENCHMARK.json').write_text(json.dumps(new))
    assert manifest.problems(manifest.load(root)) == []

    import run
    result = run.run_cell('toy.toy_mix', 7, 0.0, True, device='cpu',
                          bench=manifest.load(root))
    assert result['correct'] is True
    assert result['metrics']['toy.fits'] == {'value': 1.0, 'unit': '1'}
    assert 'k3_roofline' not in result['metrics']


def test_new_harness_is_files_only(tmp_path, bench, monkeypatch):
    """A configuration with a harness of its own (`tests/toy_landmark.py`:
    scipy CSR arms, the landmark F at 32 landmarks), added with its cell
    and limits as new files and BENCHMARK.json entries in a copy of the
    tree, with no file of the harness edited, runs `correct`; `dist` and
    `f`, which its reference does not judge, have null limits."""
    root, here = _tree(tmp_path, monkeypatch)
    shutil.copy(here / 'tests' / 'toy_landmark.py',
                here / 'harness' / 'toy_landmark.py')
    cfg = tiny(manifest.config(bench, 'scglue'))
    cfg.update(name='toy_csr', harness='toy_landmark', density=[0.2, 0.05])
    cfg['kwargs']['corr_landmarks'] = 32
    (here / 'configs' / 'toy_csr.json').write_text(json.dumps(cfg))
    (here / 'workloads' / 'toy_csr.euclidean.json').write_text(json.dumps(
        {'limits': {'dist': None, 'f': None, 'pca': 1e-3, 'embed': 1e-4,
                    'loss': 1e-4, 'dtheta': 1e-2, 'nu': 1e-2,
                    'foscttm': 0.9}}))
    new = json.loads(json.dumps(bench))
    new['configs'].append({'name': 'toy_csr', 'source': 'a test',
                           'file': 'benchmark/configs/toy_csr.json',
                           'reduced': [], 'why': 'a test'})
    new['workloads'].append({'name': 'toy_csr.euclidean',
                             'config': 'toy_csr', 'traffic': 'euclidean',
                             'chips': 1, 'why': 'a test'})
    (root / 'BENCHMARK.json').write_text(json.dumps(new))
    assert manifest.problems(manifest.load(root)) == []

    import roofline
    import run
    from roofline import prime_dual
    h100 = roofline.peaks('NVIDIA H100 80GB HBM3')
    monkeypatch.setattr(roofline, 'peaks', lambda kind: h100)
    result = run.run_cell('toy_csr.euclidean', 2 ** 31 + 7, 0.0, True,
                          device='cpu', bench=manifest.load(root))
    assert result['correct'] is True, result['checks']
    checks = result['checks']
    assert checks['dist']['value'] is None and checks['f']['value'] is None
    assert all(checks[k]['value'] is not None for k in (
        'pca', 'embed', 'loss', 'dtheta', 'nu', 'foscttm'))
    # the solve's FLOPs are the 32 x 32 landmark subproblem's
    secs = result['run']['phases'][0]['Correspondence']
    want = 100 * prime_dual.flops_per_iteration(32, 32) * 30 / secs / \
        h100['bf16_flops']
    assert result['metrics']['prime_dual.mfu']['value'] == \
        pytest.approx(want)
