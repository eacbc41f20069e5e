#!/usr/bin/env python3
"""The early stop's epoch count in jamie_tpu and in its port, side by side.

    JAX_PLATFORMS=cpu python scripts/early_stop_epochs.py \
        --package jamie_tpu --seeds 0 1 2 3 4 > jax.jsonl
    python scripts/early_stop_epochs.py \
        --package jamie_tpu_torch --seeds 0 1 2 3 4 > torch.jsonl
    python scripts/early_stop_epochs.py --summarize jax.jsonl torch.jsonl

`--pca-dim N` sets both modalities' pca_dim (default: JAMIE's 512, which
300 cells clamp to 300).

Each run is `JAMIE(manual_seed=seed).fit_transform` with every other
default on the MMD-MA sim shape of the time-and-memory harnesses (300
cells x 2000 / 1000 continuous features from `synth.synthesize`, seed 0),
so the batch holds every cell and an epoch is one step: the active loss
of an epoch is its one batch loss. The port runs on the CPU
(`device='cpu'`). Each fit prints one JSON line: the epochs it ran, the
seconds, and the per-epoch active loss from `min_epochs` on summarized
(its level at min_epochs, its median, its best and where the best fell,
and its noise: the median absolute epoch-to-epoch change relative to the
level). `--summarize` prints both packages' ranges of each.

The two packages draw their batches, dropout and noise from different
random streams (jax's key against torch's Philox), so the runs are held
against each other as distributions, not one to one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import sys
import time

import numpy as np

# both packages live at the repository's root, one level up
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _fit(package: str, seed: int, data, pca_dim=None) -> dict:
    if package == 'jamie_tpu':
        from jamie_tpu import JAMIE
        kw = {}
    else:
        from jamie_tpu_torch import JAMIE
        kw = {'device': 'cpu'}
    if pca_dim is not None:
        kw['pca_dim'] = (pca_dim, pca_dim)
    jm = JAMIE(manual_seed=seed, **kw)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        jm.fit_transform(dataset=data)
    seconds = time.perf_counter() - t0
    losses = np.asarray(jm.trainer.epoch_losses, np.float64)
    start = int(jm.config.min_epochs)
    tail = losses[start:]
    level = float(np.median(tail)) if tail.size else float('nan')
    return {
        'package': package, 'seed': seed, 'pca_dim': pca_dim,
        'epochs_run': int(jm.epochs_run),
        'seconds': round(seconds, 3), 'min_epochs': start,
        'loss_at_min_epochs': (float(losses[start]) if losses.size > start
                               else None),
        'median_after_min': level,
        'best': float(losses.min()),
        'best_epoch': int(losses.argmin()),
        'noise_after_min': (float(np.median(np.abs(np.diff(tail))) / level)
                            if tail.size > 1 else None),
    }


def _summarize(paths) -> None:
    rows = [json.loads(line) for p in paths for line in open(p)
            if line.startswith('{')]
    keys = ('epochs_run', 'loss_at_min_epochs', 'median_after_min', 'best',
            'best_epoch', 'noise_after_min')
    for package, pca_dim in sorted({(r['package'], r.get('pca_dim'))
                                    for r in rows}, key=str):
        mine = [r for r in rows if r['package'] == package
                and r.get('pca_dim') == pca_dim]
        print(json.dumps({'package': package, 'pca_dim': pca_dim,
                          'seeds': [r['seed'] for r in mine],
                          **{k: [min(r[k] for r in mine),
                                 max(r[k] for r in mine)] for k in keys}}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--package', choices=('jamie_tpu', 'jamie_tpu_torch'))
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2, 3, 4])
    ap.add_argument('--threads', type=int, default=2)
    ap.add_argument('--pca-dim', type=int, default=None)
    ap.add_argument('--summarize', nargs='+', metavar='JSONL')
    args = ap.parse_args(argv)
    if args.summarize:
        _summarize(args.summarize)
        return
    if args.package is None:
        ap.error('--package or --summarize is required')
    if args.package == 'jamie_tpu_torch':
        import torch
        torch.set_num_threads(args.threads)
    from jamie_tpu_torch.synth import synthesize
    data = synthesize((300, 2000), (300, 1000), cache=False)
    for seed in args.seeds:
        print(json.dumps(_fit(args.package, seed, data, args.pca_dim)),
              flush=True)


if __name__ == '__main__':
    sys.exit(main())
