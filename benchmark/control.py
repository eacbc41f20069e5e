"""The readings that a cell's correctness limits are set from, at the
cell's own size: the program's, the control's and the planted faults'.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--no-control] [--no-fault]

For each seed, one fit of the program with the cell's kwargs, on the
modalities of the configuration's harness module (`harness/<name>.py`),
judged against the plain reference (`check.judge` with the harness's
`Reference`, the cell's limits): the lower readings. The control: the
reference put in the program's place (its own stages, for the dense
route its distances, F and PCA subspaces, and its training on the fit's
inputs with its mean head's embeddings), each stage computed one precision
below the one the configuration states (`precision` in its file: float32
-> TF32 operands, bfloat16 -> float8 e4m3 operands with one scale per
tensor; `check.LOWER`), judged by the same `check.judge` with the cell's
limits. The faults (`FAULTS`), planted in the program and judged like
it. One JSON line per seed on standard output, each reading with its
verdict. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def state_unchanged():
    """The trainer's optimizer step leaves the parameters as they are."""
    from jamie_tpu_torch.train import trainer
    return _patched(trainer.FlatClipAdam, 'step',
                    lambda old: lambda self: None)


def half_batch():
    """Half of each batch left out: the loss, its mean and the BatchNorm
    statistics over the first half of the batch's rows."""
    from jamie_tpu_torch.train import trainer

    def make(old):
        def batch_loss(self, idx0, idx1, epoch_idx, noise=None):
            h = idx0.shape[0] // 2
            return old(self, idx0[:h], idx1[:h], epoch_idx, noise)
        return batch_loss
    return _patched(trainer.JamieTrainer, 'batch_loss', make)


# The faults a one-chip fit can have that the control does not plant: the
# exchange between chips does not exist in these cells
FAULTS = {'state_unchanged': state_unchanged, 'half_batch': half_batch}


def control_outputs(ctrl, out: dict, device) -> dict:
    """The control's outputs in the program's place: its own stages' (for
    the dense route its distances, F and PCA subspaces), and its training
    on the fit's training inputs and F with its mean head's embeddings."""
    r = ctrl.train(out['T'], ctrl.training_f(out), out['manual_seed'])
    o = {**ctrl.own(), 'T': out['T'],
         'params': {**r['params'], **r['stats']}, 'nu': r['nu'],
         'epoch_losses': r['epoch_losses'],
         'manual_seed': out['manual_seed']}
    o['emb'] = [ctrl.embed(o, i, device).float() for i in range(len(o['T']))]
    return o


def detail(want, out: dict, device) -> dict:
    """Per modality and per norm, for the look behind a reading: the
    route's own (`Reference.detail`) and the training's."""
    import torch
    import check
    r = want.train(out['T'], want.training_f(out), out['manual_seed'])
    keep, init = check.moving_leaves(r['grad1']), r['init']
    return {
        **want.detail(out, device),
        'loss_epochs': [list(out['epoch_losses'][:3]),
                        r['epoch_losses'][:3]],
        # the three worst leaves of `dtheta` and `nu`
        'dtheta_leaves': _worst(check.leaf_gaps(
            {k: torch.as_tensor(out['params'][k]).to(device) - init[k]
             for k in keep}, {k: r['params'][k] - init[k] for k in keep},
            keep)),
        'nu_leaves': _worst(check.leaf_gaps(out['nu'], r['nu'], keep)),
    }


def _worst(gaps: dict, n: int = 3) -> list:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def _judged(outs, want, limits, device, seed) -> dict:
    import check
    t = time.perf_counter()
    worst, _, failed = check.judge(outs, want, limits, device, seed)
    return {'numbers': worst, 'correct': failed == 0,
            'check_s': time.perf_counter() - t}


def readings(cell_name: str, seeds, device=None, bench=None, config=None,
             limits=None, control: bool = True, fault: bool = True):
    """Yield one dict of readings per seed."""
    if str(HERE.parent) not in sys.path:
        sys.path.insert(1, str(HERE.parent))
    import manifest
    bench = manifest.load() if bench is None else bench
    cell = manifest.cell(bench, cell_name)
    config = manifest.config(bench, cell['config']) if config is None \
        else config
    traffic = manifest.traffic(cell['traffic'])
    limits = manifest.limits(cell_name) if limits is None else limits

    import torch
    import jamie_tpu_torch  # noqa: F401
    import run
    harness = manifest.harness(config)
    device = torch.device('cuda', 0) if device is None else \
        torch.device(device)
    warm = False
    for seed in seeds:
        t0 = time.perf_counter()
        host, _ = harness.make_host(config, seed, device)
        if not warm:
            run.one_fit(host, run.fit_kwargs(config, traffic, seed,
                                             traffic['warmup']),
                        device, harness, config, keep=False)
            warm = True
        kwargs = run.fit_kwargs(config, traffic, seed)
        rec = run.one_fit(host, kwargs, device, harness, config)
        out = rec.pop('out')
        run._free(device)
        want = harness.Reference(host, config, traffic, device)
        row = {'seed': seed, 'fit_s': rec['seconds']}
        row['program'] = _judged([out], want, limits, device, seed)
        row['detail'] = detail(want, out, device)
        if control:
            ctrl = harness.Reference(host, config, traffic, device,
                                     control=True)
            row['control'] = _judged([control_outputs(ctrl, out, device)],
                                     want, limits, device, seed)
            del ctrl
        if fault:
            for name, plant in FAULTS.items():
                with plant():
                    frec = run.one_fit(host, kwargs, device, harness,
                                       config)
                row[f'fault_{name}'] = _judged([frec['out']], want, limits,
                                               device, seed)
                del frec
                run._free(device)
        row['seconds'] = time.perf_counter() - t0
        del want, out
        run._free(device)
        yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--no-control', action='store_true')
    p.add_argument('--no-fault', action='store_true')
    args = p.parse_args(argv)
    import run
    run._caches()
    result_fd = os.dup(1)
    os.dup2(2, 1)
    seeds = [int(s) for s in args.seeds.split(',')]
    for row in readings(args.workload, seeds, control=not args.no_control,
                        fault=not args.no_fault):
        os.write(result_fd, (json.dumps(row) + '\n').encode())
    return 0


if __name__ == '__main__':
    sys.exit(main())
