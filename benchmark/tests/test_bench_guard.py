"""The run's guards: the whole-name import guard, no result without a
card or without the program, and the trace's own checks."""

import subprocess
import sys

import pytest

import manifest
import run
import tracing

REPO = manifest.REPO


@pytest.mark.parametrize('names,found', [
    (['jamie_tpu_torch', 'jamie_tpu_torch.ops', 'numpy'], []),
    (['jamie_tpu.ops.distances'], ['jamie_tpu']),
    (['jamie_tpu'], ['jamie_tpu']),
    (['jax', 'jaxlib.xla_client', 'flax.linen'], ['flax', 'jax', 'jaxlib']),
    (['jaxtyping', 'flaxy', 'jamie_tpu_x'], []),
])
def test_forbidden_is_a_whole_top_level_name(names, found):
    assert run.forbidden_modules(names) == found


def _imports(code):
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_harness_and_program_load_no_jax():
    loaded = _imports(
        'import sys; sys.path[:0] = ["benchmark", "."]\n'
        'import run, check, control, datagen, tracing, manifest\n'
        'import jamie_tpu_torch, jamie_tpu_torch.estimator\n'
        'print(*run.forbidden_modules(sys.modules))')
    assert loaded == []


def test_reference_imports_nothing_of_the_program():
    loaded = _imports(
        'import sys; sys.path[:0] = ["benchmark"]\n'
        'import reference, datagen\n'
        'print(*sorted({m.split(".")[0] for m in sys.modules}))')
    assert 'jamie_tpu_torch' not in loaded
    assert 'jamie_tpu' not in loaded and 'jax' not in loaded


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'scmnc_visual.geodesic', '--seed', '3', '--seconds', '1',
         '--trace', '0', *args], capture_output=True, text=True, cwd=cwd,
        timeout=300)


def test_no_card_no_result():
    out = _cli(REPO)
    assert out.returncode != 0 and out.stdout == ''


def test_without_the_program_no_result(tmp_path):
    import shutil
    shutil.copy(REPO / 'BENCHMARK.json', tmp_path)
    shutil.copytree(REPO / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ''
    # past the look for a card, the program itself is missing
    out = subprocess.run(
        [sys.executable, '-c', 'import sys; sys.path[:0] = ["benchmark"]\n'
         'import run\n'
         'run.run_cell("scmnc_visual.geodesic", 1, 0, False, device="cpu")'],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ''
    assert "No module named 'jamie_tpu_torch'" in out.stderr


def test_trace_without_device_events_fails_on_the_card():
    empty = {'device_events': 0, 'busy_s': 0.0, 'window_s': 1.0,
             'kernels': {}, 'breakdown': {}}
    with pytest.raises(run.RunFailed):
        run.trace_fields(empty, strict=True)
    assert run.trace_fields(empty, strict=False) == {}


def test_missing_kernel_fails_a_strict_trace(bench, tiny_configs):
    record = {'fits': [], 'config': tiny_configs['scmnc_visual'],
              'traffic': {}, 'peaks': {'hbm_bytes_per_s': 3.35e12,
                                       'tf32_flops': 495e12},
              'trace': {'device_events': 5, 'busy_s': 1.0, 'window_s': 2.0,
                        'kernels': {'some_other_kernel': [1.0, 5]}}}
    with pytest.raises(run.RunFailed, match='k1_roofline|trainer|distances'):
        run.per_layer(bench, 'scmnc_visual.geodesic', record, strict=True)


def test_union_of_device_intervals():
    import numpy as np
    s, e = tracing._merge(np.array([5, 0, 2, 20]), np.array([8, 3, 4, 25]))
    assert list(s) == [0, 5, 20] and list(e) == [4, 8, 25]
