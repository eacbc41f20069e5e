"""The control, the reference in the program's place one precision below
the configuration's for each stage, comes out not correct under the
cell's limits, and so does each planted fault, where the program comes
out correct (at a tiny size on the CPU, with limits set as the cells'
are: between the program's readings and the control's; the readings at
each cell's size are in PERF.md)."""

import pytest

import control
from test_bench_faults import LIMITS


@pytest.mark.parametrize('cell', ['scglue.euclidean',
                                  'scmnc_visual.geodesic'])
def test_control_and_faults_are_not_correct(cell, bench, tiny_configs):
    import manifest
    cfg = tiny_configs[manifest.cell(bench, cell)['config']]
    row = next(control.readings(cell, [2 ** 31 + 3], device='cpu',
                                bench=bench, config=cfg, limits=LIMITS))
    assert row['program']['correct'] is True, row['program']
    assert row['control']['correct'] is False, row['control']
    prog, ctrl = row['program']['numbers'], row['control']['numbers']
    # the model stage in TF32, both in inference and in training
    assert ctrl['embed'] > 100 * prog['embed']
    assert ctrl['loss'] > 100 * prog['loss']
    for name in control.FAULTS:
        assert row[f'fault_{name}']['correct'] is False, name
    # a state left unchanged has not moved at all
    assert row['fault_state_unchanged']['numbers']['dtheta'] == 1.0
