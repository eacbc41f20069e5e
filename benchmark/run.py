"""The benchmark of `jamie_tpu_torch`, the PyTorch and CUDA port of JAMIE:
whole `JAMIE().fit_transform` fits at published dataset shapes.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell (`workloads` in BENCHMARK.json) is a configuration (its shapes and
JAMIE kwargs, `configs/`) under a traffic mix (`traffic/`). One run:

1. set-up: the Triton cache pointed at a fixed directory in the checkout
   (the port's nvcc libraries already live in `jamie_tpu_torch/_build/`),
   the modalities made from the seed and brought to the host as a user's
   data arrive, by the configuration's harness module (`harness/<name>.py`,
   `dense` by default: the pair made on the card by `datagen.py` and
   copied to host numpy once), one warm-up fit at the cell's shapes with
   the traffic's tiny schedule;
2. the window: whole fits back to back on the same host arrays, each a new
   `JAMIE(manual_seed=...)` after `clear_residency_cache()`, timed from
   the call to the returned embeddings, the device's peak reset before
   each; a new fit starts while the elapsed time is under `--seconds`,
   and the fit in flight finishes. `peak_gib` is the first fit's peak.
   With `--trace 1` the first fit runs under `torch.profiler` until the
   end of its second training epoch (`tracing.py`);
3. the check: every fit against the plain reference (`check.py`, with
   the harness's `Reference` for the stages of its route), and the
   training of one fit drawn from the seed against the reference's
   training, once the window has closed and the fits' device state is
   freed.

The program's own prints go to standard error; the last line of standard
output is one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and `checks` last). The run exits
with a nonzero code and prints no result without a CUDA card, when it
finds JAX or `jamie_tpu` loaded, when a traced fit's trace holds no
device event, or when a per-layer metric it reports finds nothing to
read.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse   # noqa: E402
import faulthandler   # noqa: E402
import gc   # noqa: E402
import importlib   # noqa: E402
import json   # noqa: E402
import os   # noqa: E402
import statistics   # noqa: E402
import sys   # noqa: E402
import traceback   # noqa: E402
from pathlib import Path   # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / '.cache'
# Compared by whole top-level name: `jamie_tpu_torch` is not `jamie_tpu`
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'jamie_tpu')


class RunFailed(RuntimeError):
    """A run that prints no result."""


def forbidden_modules(names) -> list:
    """The top-level names among `names` that a run may not load."""
    return sorted({n.split('.', 1)[0] for n in names
                   if n.split('.', 1)[0] in FORBIDDEN})


def fit_kwargs(config: dict, traffic: dict, seed: int, overrides=None):
    kw = dict(config['kwargs'])
    kw.update(traffic['kwargs'])
    kw.update(overrides or {})
    for key in ('pca_dim', 'loss_weights'):
        if key in kw and isinstance(kw[key], list):
            kw[key] = tuple(kw[key])
    # numpy seeds the estimator's host draws and takes 32 bits
    kw['manual_seed'] = int(seed) % (2 ** 32)
    return kw


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _host(t):
    import numpy as np
    import torch
    if isinstance(t, (list, tuple)):
        return [_host(x) for x in t]
    if isinstance(t, torch.Tensor):
        return t.detach().to('cpu', copy=True)
    return torch.from_numpy(np.array(t, copy=True))


def one_fit(data, kwargs: dict, device, harness, config: dict,
            keep: bool = True) -> dict:
    """One timed fit from what a user's first fit finds; its record and,
    with `keep`, what it produced (on the host): what every route
    produces, and what the configuration's `harness` module names."""
    import torch
    from jamie_tpu_torch import JAMIE, ops
    from jamie_tpu_torch.core.residency import (clear_residency_cache,
                                                reset_transfer_stats,
                                                transfer_stats)
    clear_residency_cache()
    reset_transfer_stats()
    ops.reset_launch_counts()
    jm = JAMIE(device=None if device.type == 'cuda' else device, **kwargs)
    _sync(device)
    t0 = time.perf_counter()
    emb = jm.fit_transform(dataset=data)
    _sync(device)
    seconds = time.perf_counter() - t0
    tr = jm.trainer
    shape, state_dtype = harness.solve(jm, config, kwargs)
    rec = {
        'seconds': seconds,
        'phases': dict(jm.phase_timings),
        'mapping': {k: float(v) for k, v in jm._mapping_timings.items()},
        'transfer': transfer_stats(),
        'launches': ops.launch_counts(),
        'epochs_run': int(jm.epochs_run),
        'steps_per_epoch': int(tr.len_dataloader),
        'batch': int(tr.batch_size),
        'epoch_pd': int(kwargs['epoch_pd']),
        # the shape K1 and the solve ran at, and their state dtype
        'solve_shape': [int(n) for n in shape],
        'solver_state_dtype': state_dtype,
    }
    if keep:
        # Adam's second moment by leaf: the flat vector in the order of the
        # model's parameters
        named = list(jm.model.named_parameters())
        nu = torch.split(jm.train_state.nu.detach(),
                         [p.numel() for _, p in named])
        rec['out'] = {
            'emb': [_host(e) for e in emb],
            **{k: _host(v) for k, v in harness.produced(jm).items()},
            'T': [_host(x) for x in tr.data],
            'params': {k: _host(v) for k, v in jm.model.state_dict().items()},
            'nu': {n: _host(v.view(p.shape)) for (n, p), v in zip(named, nu)},
            'epoch_losses': [float(v) for v in tr.epoch_losses],
            'manual_seed': int(kwargs['manual_seed']),
        }
    del jm, tr, emb
    return rec


def _free(device):
    import torch
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def _work_checks(fits: list, kwargs: dict) -> list:
    """What every fit must have done alike: the first fit's upload bytes,
    every epoch and every prime-dual iteration (K1 launches are counted
    on the card only; the CPU runs K1's plain version)."""
    bad = []
    first = fits[0]['transfer']['bytes']
    for k, f in enumerate(fits):
        if f['transfer']['bytes'] != first:
            bad.append(f'fit {k} uploaded {f["transfer"]["bytes"]} bytes, '
                       f'the first {first}')
        if f['epochs_run'] != kwargs['epoch_DNN']:
            bad.append(f'fit {k} ran {f["epochs_run"]} epochs of '
                       f'{kwargs["epoch_DNN"]}')
        k1 = f['launches'].get('fused_pd_grad_update', 0)
        if f['on_card'] and k1 != kwargs['epoch_pd']:
            bad.append(f'fit {k} launched K1 {k1} times for '
                       f'{kwargs["epoch_pd"]} iterations')
    return bad


def trace_fields(summary, strict: bool) -> dict:
    """`busy_s` and `window_s` of the traced fit. A trace that holds no
    device event fails the run where `strict` (on the card)."""
    if summary is None or summary['device_events'] == 0:
        if strict:
            raise RunFailed('the traced fit holds no device event')
        return {}
    return {'busy_s': summary['busy_s'], 'window_s': summary['window_s']}


def per_layer(bench: dict, cell_name: str, record: dict,
              strict: bool) -> dict:
    """The cell's per-layer metrics, each from its reader. A reader that
    finds nothing leaves its metric out, and fails the run where
    `strict` (on the card): the cell lists it."""
    import manifest
    metrics = {}
    for m in manifest.metrics_for(bench, 'per_layer', cell_name):
        value = manifest.reader(m['name'])(record)
        if value is None:
            if strict:
                raise RunFailed(f'{m["name"]}: nothing to read')
            continue
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
    return metrics


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device=None, bench=None, config=None, limits=None,
             t_start=None, cold=None) -> dict:
    """One run of a cell; returns the result object. `device` (default the
    card), `bench`, `config` and `limits` let a test drive a run at a
    small size on the CPU. `cold`: whether the kernel caches were empty
    (reported)."""
    t_start = time.perf_counter() if t_start is None else t_start
    # the program is the checkout's own package, beside this folder
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
    import jamie_tpu_torch  # noqa: F401  (pins float32 matmuls)
    import check
    import tracing
    from roofline import peaks as card_peaks
    device = torch.device('cuda', 0) if device is None else \
        torch.device(device)
    on_card = device.type == 'cuda'
    for name in traffic.get('preload', []):
        importlib.import_module(name)
    harness = manifest.harness(config)

    # ---- set-up
    if on_card:
        torch.cuda.init()
    t_init = time.perf_counter() - t_start
    host, made_s = harness.make_host(config, seed, device)
    t = time.perf_counter()
    one_fit(host, fit_kwargs(config, traffic, seed, traffic['warmup']),
            device, harness, config, keep=False)
    _free(device)
    t_warm = time.perf_counter() - t
    kwargs = fit_kwargs(config, traffic, seed)
    setup_s = time.perf_counter() - t_start

    # ---- the window
    fits, outs, errors = [], [], []
    summary = None
    t_w = time.perf_counter()
    while not fits or time.perf_counter() - t_w < seconds:
        if on_card:
            live = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        try:
            if trace and not fits:
                with tracing.TracedFit() as traced:
                    rec = one_fit(host, kwargs, device, harness, config)
                summary = tracing.summarize(traced.prof)
                del traced
            else:
                rec = one_fit(host, kwargs, device, harness, config)
        except Exception:   # a fit that fails is counted, not retried
            errors.append(traceback.format_exc())
            print(errors[-1], file=sys.stderr)
            break
        rec['on_card'] = on_card
        if on_card:
            rec['peak_bytes'] = int(torch.cuda.max_memory_allocated(device))
            rec['live_before_bytes'] = int(live)
        outs.append(rec.pop('out'))
        fits.append(rec)
        _free(device)
    window_s = time.perf_counter() - t_w
    # the window's peak, and the first fit's: each fit leaves some device
    # memory allocated (PERF.md), so the window's grows with its fits
    peak = max((f.get('peak_bytes', 0) for f in fits), default=0)
    first_peak = fits[0].get('peak_bytes', 0) if fits else 0
    _free(device)

    # ---- the check
    t = time.perf_counter()
    bad = _work_checks(fits, kwargs) if fits else []
    for b in bad:
        print(f'work check: {b}', file=sys.stderr)
    if outs:
        want = harness.Reference(host, config, traffic, device)
        worst, per_fit, failed = check.judge(outs, want, limits, device,
                                             seed)
        del want
    else:
        worst = {k: float('nan') for k in check.NUMBERS}
        per_fit, failed = [], 0
    failed += len(errors)
    correct = bool(fits) and not errors and not bad and failed == 0
    check_s = time.perf_counter() - t
    for k, p in enumerate(per_fit):
        print(f'fit {k}: ' + json.dumps(p), file=sys.stderr)

    kind = torch.cuda.get_device_name(device) if on_card else 'cpu'
    peaks = card_peaks(kind)
    result = {'correct': correct, 'attempted': len(fits) + len(errors),
              'failed': failed}
    result['device'] = {'platform': 'gpu' if on_card else 'cpu',
                        'kind': kind, 'count': 1, 'memory_peak_bytes': peak}
    if trace:
        result['device'].update(trace_fields(summary, strict=on_card))
        timed = fits[1:] if len(fits) > 1 else fits
        record = {'fits': timed, 'trace': summary, 'config': config,
                  'traffic': traffic, 'peaks': peaks}
        metrics = per_layer(bench, cell_name, record, strict=on_card)
        if summary is not None:
            result['breakdown'] = summary['breakdown']
    else:
        fit_s = statistics.fmean(f['seconds'] for f in fits) if fits \
            else None
        values = {'fit_s': fit_s, 'peak_gib': first_peak / 2 ** 30,
                  'setup_s': setup_s}
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in manifest.metrics_for(bench, 'end_to_end',
                                                 cell_name)}
    result['metrics'] = metrics
    result['run'] = {'seed': seed, 'fits': [f['seconds'] for f in fits],
                     'window_s': window_s, 'setup': {
                         'imports_and_card_s': t_init,
                         'data_s': made_s['data_s'],
                         'host_copy_s': made_s['host_copy_s'],
                         'warmup_fit_s': t_warm, 'cold_caches': cold},
                     'check_s': check_s,
                     'phases': [f['phases'] for f in fits],
                     'peak_bytes': [f.get('peak_bytes') for f in fits],
                     'live_before_bytes': [f.get('live_before_bytes')
                                           for f in fits]}
    result['checks'] = check.checks_line(worst, limits)
    return result


def _caches() -> bool:
    """Point the kernel caches at fixed directories in the checkout;
    whether they were empty (a run that builds and compiles)."""
    triton = CACHE / 'triton'
    triton.mkdir(parents=True, exist_ok=True)
    os.environ['TRITON_CACHE_DIR'] = str(triton)
    build = HERE.parent / 'jamie_tpu_torch' / '_build'
    return not any(triton.iterdir()) or not (
        build.is_dir() and any(build.glob('*.so')))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    faulthandler.enable()
    cold = _caches()
    # the program prints progress to stdout: all of it goes to stderr, and
    # stdout carries the result line alone
    result_fd = os.dup(1)
    os.dup2(2, 1)
    import torch
    import manifest
    bench = manifest.load()
    chips = manifest.cell(bench, args.workload)['chips']
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f'needs {chips} CUDA card(s); found {cards}', file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), bench=bench, t_start=_T0,
                          cold=cold)
    except RunFailed as e:
        print(f'run failed: {e}', file=sys.stderr)
        return 3
    found = forbidden_modules(sys.modules)
    if found:
        print(f'loaded, and may not be: {", ".join(found)}', file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]} (limit {c["limit"]})',
              file=sys.stderr)
    sys.stderr.flush()
    os.write(result_fd, (json.dumps(result) + '\n').encode())
    return 0


if __name__ == '__main__':
    sys.exit(main())
