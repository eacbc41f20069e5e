"""The port's time-and-memory harness (`jamie_tpu_torch.time_and_memory`)
against the repo's `examples/time_and_memory.py`: the same configs, and
the same tiny fit through both `run_config`s (F, FOSCTTM, record keys)."""

import faulthandler
import importlib
import pathlib
import sys

import numpy as np
import pytest

from jamie_tpu_torch import synth
from jamie_tpu_torch import time_and_memory as tm

ROOT = pathlib.Path(__file__).resolve().parent.parent

# examples/time_and_memory.py's record keys (:81-104)
RECORD_KEYS = {'dataset', 'shapes', 'input_variant', 'total_seconds',
               'reference_cpu_seconds', 'speedup', 'epochs_run', 'phases',
               'upload_mb', 'upload_mb_bf16_equiv', 'host_read_s',
               'host_encode_s'}


def _examples_tm():
    """examples/time_and_memory.py, with the exit watchdog it arms at
    import cancelled."""
    path = str(ROOT / 'examples')
    if path not in sys.path:
        sys.path.insert(0, path)
    mod = importlib.import_module('time_and_memory')
    faulthandler.cancel_dump_traceback_later()
    return mod


def test_configs_equal_the_jax_harness():
    assert tm.CONFIGS == _examples_tm().CONFIGS


@pytest.mark.parametrize('key', sorted(tm.CONFIGS))
def test_config_args(key):
    name, s0, s1, ref, b1 = tm.config_args(key)
    cfg = tm.CONFIGS[key]
    assert (name, s0, s1) == cfg[0] and ref == cfg[1]
    assert b1 == (cfg[2] if len(cfg) > 2 else None)
    assert s0[0] == s1[0]   # paired cells


@pytest.fixture(scope='module')
def both_fits(tmp_path_factory):
    """The same tiny config through both harnesses' run_config, the synth
    caches in a temporary directory.

    Both solve F with float32 GEMMs (solver_dtype='float32'): with the
    default bf16 GEMMs the two packages round the same operands but sum
    the products in other orders, and 2000 Adam iterations amplify that
    (measured on this input: F within 6e-5 of its largest entry after 100
    iterations, 1e-2 after 2000, against 8e-2 between bf16 and f32 GEMMs
    in either package; tests/test_torch_prime_dual.py holds the bf16 solve
    at 50 iterations)."""
    import jamie_tpu
    from jamie_tpu.core import residency as JR
    from jamie_tpu_torch import estimator

    ex = _examples_tm()
    ex_synth = sys.modules['synth']
    cache = tmp_path_factory.mktemp('synth')
    mp = pytest.MonkeyPatch()
    fits = {}

    class Capture(jamie_tpu.JAMIE):
        def __init__(self, *a, **k):
            super().__init__(*a, solver_dtype='float32', **k)

        def fit_transform(self, *a, **k):
            out = super().fit_transform(*a, **k)
            fits['jax'] = (self, out)
            return out

    class F32Solve(estimator.JAMIE):
        def __init__(self, *a, **k):
            super().__init__(*a, solver_dtype='float32', **k)
    try:
        mp.setattr(ex_synth, 'SYNTH_CACHE', str(cache / 'jax'))
        mp.setattr(synth, 'SYNTH_CACHE', str(cache / 'torch'))
        mp.setattr(JR, 'enable_encode_cache', lambda *a, **k: None)
        mp.setattr(jamie_tpu, 'JAMIE', Capture)
        mp.setattr(estimator, 'JAMIE', F32Solve)
        # a 60-feature modality and one (29) narrower than scMNC-Motor's
        # PCA target, both under pca_dim=512
        args = ('tiny', (120, 60), (120, 29), 100.0)
        kw = dict(epoch_dnn=30, min_epochs=0)
        try:
            ref = ex.run_config(*args, **kw)
        finally:
            faulthandler.cancel_dump_traceback_later()

        def on_fit(jm, out, dataset):
            fits['torch'] = (jm, out, dataset)
        ours = tm.run_config(*args, device='cpu', on_fit=on_fit, **kw)
    finally:
        mp.undo()
    return ref, ours, fits


def test_record_keys_match(both_fits):
    ref, ours, _ = both_fits
    assert set(ref) == set(ours) == RECORD_KEYS
    assert set(ref['phases']) == set(ours['phases']) == {
        'Distance', 'Correspondence', 'Mapping'}
    for k in ('dataset', 'shapes', 'input_variant', 'reference_cpu_seconds',
              'epochs_run', 'upload_mb', 'upload_mb_bf16_equiv'):
        assert ours[k] == ref[k], k
    assert ours['total_seconds'] > 0
    assert ours['speedup'] == 100.0 / ours['total_seconds']


def test_the_same_data_and_correspondence(both_fits):
    _, _, fits = both_fits
    jj, _ = fits['jax']
    tj, _, dataset = fits['torch']
    assert jj.config.solver_dtype == tj.config.solver_dtype == 'float32'
    for a, b in zip(jj.dataset, dataset):
        assert np.array_equal(np.asarray(a), b)
    ref = np.asarray(jj.match_result[0])
    ours = tj.match_result[0].cpu().numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * ref.max())


def test_integration_quality_in_the_same_band(both_fits):
    _, _, fits = both_fits
    jj, jout = fits['jax']
    tj, tout, _ = fits['torch']
    f_ref = float(jj.test_closer(jout))
    f_ours = float(tj.test_closer(tout))
    assert all(e.shape == (120, 32) and np.isfinite(e).all() for e in tout)
    assert abs(f_ours - f_ref) < 0.02, (f_ours, f_ref)


def test_main_prints_a_record_per_config(capsys, monkeypatch, tmp_path):
    monkeypatch.setitem(tm.CONFIGS, 'tiny', (('Tiny', (80, 40), (80, 30)),
                                             50.0, 0.05))
    res = tm.main(['--configs', 'tiny', '--epoch-dnn', '3',
                   '--min-epochs', '0'], device='cpu', cache=tmp_path)
    assert len(res) == 1
    rec = res[0]
    assert set(rec) == RECORD_KEYS | {'foscttm', 'max_memory_allocated'}
    assert rec['input_variant'] == 'zb5' and rec['epochs_run'] == 3
    assert 0 <= rec['foscttm'] <= 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'tm_80x30_0_1_zb5.npy', 'tm_80x40_0_0.npy']
    assert '=== Tiny (80, 40) (80, 30) ===' in capsys.readouterr().out
