"""The harness modules (`harness/<name>.py`): the dense one makes the same
host arrays, and its runs read the same checks, as the benchmark did
before a configuration named its harness; a number a harness leaves out
(NaN) fails a limit that is not null."""

import math

import numpy as np
import pytest
import torch

import check
import datagen
import manifest
import run
from test_bench_reference import TIGHT

SEEDS = (2 ** 31 + 5, 12345)

# The checks of a tiny CPU run of each cell (`conftest.tiny`, TIGHT limits,
# one torch thread) as the benchmark read them before harness modules:
# make_pair on the device and one copy to the host, the dense reference
# in check.py
BEFORE = {
    'scglue.euclidean/2147483653': {
        'dist': 4.553158893647724e-06, 'f': 2.0923005234878977e-05,
        'pca': 2.8255996607861614e-07, 'embed': 2.566696650774247e-07,
        'loss': 0.0, 'dtheta': 1.7490576165848847e-07,
        'nu': 2.39216741894937e-07, 'foscttm': 0.2154888888888889
    },
    'scglue.euclidean/12345': {
        'dist': 5.4218526651733515e-06, 'f': 2.4420968793680823e-05,
        'pca': 3.171174147776175e-07, 'embed': 2.7797034363175044e-07,
        'loss': 0.0, 'dtheta': 0.00034413116473033524,
        'nu': 0.0005152631907724961, 'foscttm': 0.1256
    },
    'scmnc_visual.geodesic/2147483653': {
        'dist': 1.3741823687590232e-07, 'f': 4.712500641915029e-06,
        'pca': 2.8255996607861614e-07, 'embed': 2.1524608939671452e-07,
        'loss': 0.0, 'dtheta': 2.0703940632034082e-07,
        'nu': 2.1204842260251075e-07, 'foscttm': 0.03897777777777778
    },
    'scmnc_visual.geodesic/12345': {
        'dist': 1.374466259841889e-07, 'f': 5.437970867569115e-06,
        'pca': 3.171174147776175e-07, 'embed': 2.29112075089688e-07,
        'loss': 0.0, 'dtheta': 3.345084845539931e-07,
        'nu': 4.83158994956249e-06, 'foscttm': 0.029377777777777777
    },
}


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('name', ['scglue', 'scmnc_visual'])
def test_dense_host_arrays_are_make_pair_copied(name, seed, tiny_configs):
    cfg = tiny_configs[name]
    dense = manifest.harness(cfg)
    host, secs = dense.make_host(cfg, seed, torch.device('cpu'))
    want = [x.cpu().numpy() for x in
            datagen.make_pair(cfg, seed, torch.device('cpu'))]
    assert len(host) == len(want) == 2
    for got, w in zip(host, want):
        assert isinstance(got, np.ndarray) and got.dtype == w.dtype
        assert got.shape == w.shape and got.tobytes() == w.tobytes()
    assert set(secs) == {'data_s', 'host_copy_s'}
    assert all(v >= 0 for v in secs.values())


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('cell', ['scglue.euclidean',
                                  'scmnc_visual.geodesic'])
def test_dense_checks_are_as_before(cell, seed, bench, tiny_configs):
    cfg = tiny_configs[manifest.cell(bench, cell)['config']]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = run.run_cell(cell, seed, 0.0, False, device='cpu',
                              bench=bench, config=cfg, limits=TIGHT)
    finally:
        torch.set_num_threads(threads)
    got = {k: c['value'] for k, c in result['checks'].items()}
    assert got == pytest.approx(BEFORE[f'{cell}/{seed}'], rel=1e-3)


@pytest.mark.parametrize('number', check.NUMBERS)
def test_a_missing_number_fails_a_limit(number):
    limits = {k: 1.0 for k in check.NUMBERS}
    p = {k: 0.5 for k in check.NUMBERS}
    assert not check._fails(p, limits)
    p[number] = math.nan
    assert check._fails(p, limits)
    # a null limit compares nothing
    assert not check._fails(p, dict(limits, **{number: None}))
    # the training numbers are compared in the fit whose training is
    # compared, and only there
    assert check._fails(p, limits, trained=False) is (
        number not in check.TRAINING)


def test_a_missing_number_fails_a_run(bench, tiny_configs, monkeypatch):
    """A harness whose reference leaves `f` out (NaN) fails a run whose
    limit for `f` is not null, and passes one whose limit is null."""
    cfg = tiny_configs['scmnc_visual']
    dense = manifest.harness(cfg)
    numbers = dense.Reference.numbers
    monkeypatch.setattr(dense.Reference, 'numbers', lambda self, out, dev:
                        dict(numbers(self, out, dev), f=math.nan))
    monkeypatch.setattr(manifest, 'harness', lambda config: dense)
    results = [run.run_cell('scmnc_visual.geodesic', 3, 0.0, False,
                            device='cpu', bench=bench, config=cfg,
                            limits=dict(TIGHT, f=f)) for f in (1.0, None)]
    assert [r['correct'] for r in results] == [False, True]
    assert [r['checks']['f'] for r in results] == [
        {'value': None, 'limit': 1.0}, {'value': None, 'limit': None}]
