"""Headline benchmark of the port: SNARE-seq-class coupled-VAE training
throughput, plus the whole-pipeline scGLUE-shaped fit.

    python -m jamie_tpu_torch.bench

The twin of the repo's `bench.py`. Prints ONE JSON line on stdout:
{"metric", "value", "unit", "vs_baseline", "extra"}, with bench.py's keys.

- Train leg: cell-samples/s through the trainer's chunk function
  (`JamieTrainer._chunk_fn`, bench.py's `_chunk_fn(cfg.epoch_chunk)`:
  sampling, P/F row normalization, forward, 4-term loss, backward, clip,
  Adam and the bookkeeping, on the card as replays of the captured epoch)
  on `make_snare_like()` (1047 cells, 3000 RNA / 5000 ATAC) after PCA-512,
  with bf16 model matmuls, P = I and F = 0, batch 512: one warm-up chunk of
  `epoch_chunk` epochs discarded, then `timed_chunks` chunks between
  device synchronizations. `train_achieved_tflops` counts one eager step's
  FLOPs with `torch.utils.flop_counter.FlopCounterMode` (a replayed graph
  hides its ops from the counter) and scales them by the steps;
  `train_mfu_vs_card_bf16_peak` divides it by the dense bf16 peak of the
  card it ran on (null where the card is not in `BF16_DENSE_PEAK`, or on
  the CPU).
- Pipeline leg: the wall time of a whole `JAMIE().fit_transform` at the
  scGLUE shape (9190 cells x 28,930 RNA / 241,757 ATAC features, binary
  ATAC z-scored per column; `synth.synthesize`), every option at its
  default but the chunking, logging and bf16 model matmuls; the median of
  `JAMIE_BENCH_PIPELINE_REPS` runs (default 3) with its band, each run's
  phase split and the residency's transfer statistics.

Switches (bench.py's meanings and defaults): JAMIE_BENCH_PIPELINE=0 skips
the pipeline leg; JAMIE_BENCH_PIPELINE_REPS sets its runs;
JAMIE_BENCH_ATAC=continuous fits the continuous-Gaussian ATAC variant. A
failed pipeline leg still prints the train record, with
`scglue_pipeline_error`, and exits 1. Each fit's FOSCTTM, device peak,
`manual_seed` and epochs go to a stderr progress line; one pipeline fit at
another seed is `main(pipeline_kw={'manual_seed': s, 'reps': 1})`.

Left out of bench.py: the device bring-up timer and the pipeline watchdog
(written for a TPU pool that could hang for tens of minutes before any
work), and `prng_impl='rbg'` (the TPU's hardware generator; the port's
config keeps the field and ignores it). The numbers are not rounded.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from .synth import make_snare_like, synthesize

# The reference PyTorch-CPU training phase sustains ~6-17k cell-samples/s
# (batch 512 x batches per epoch over epoch time) on its committed
# time-and-memory notebook runs; the upper end keeps vs_baseline
# conservative.
BASELINE_CELLS_PER_SEC = 17_000.0
# The reference's CPU notebook on the scGLUE data (time-and-memory.ipynb
# cell 33)
SCGLUE_REF_SECONDS = 52_557.4
SCGLUE_SHAPES = ((9190, 28930), (9190, 241757))

# Dense bf16 tensor-core peak (NVIDIA data sheet), by
# torch.cuda.get_device_name
BF16_DENSE_PEAK = {
    'NVIDIA H100 80GB HBM3': 989e12,   # H100 SXM
}


def card_bf16_peak(device) -> Optional[float]:
    """The dense bf16 peak of `device`'s card, or None (the CPU, or a card
    not in BF16_DENSE_PEAK)."""
    if device.type != 'cuda':
        return None
    return BF16_DENSE_PEAK.get(torch.cuda.get_device_name(device))


def _sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def train_leg(data=None, pca_dim=512, epoch_chunk=200, timed_chunks=5,
              device=None) -> dict:
    """The train record: bench.py's metric, value, unit, vs_baseline and
    extra {train_achieved_tflops, train_mfu_vs_card_bf16_peak}."""
    from torch.utils.flop_counter import FlopCounterMode

    from .config import JamieConfig
    from .core.dtypes import resolve_device
    from .models import CoupledVAE
    from .preprocess import Preprocessor
    from .train.trainer import JamieTrainer

    device = resolve_device(device)
    if data is None:
        data, _ = make_snare_like()
    n = data[0].shape[0]
    cfg = JamieConfig(epoch_DNN=10_000, min_epochs=2500, batch_size=512,
                      log_DNN=100_000, use_early_stop=False,
                      epoch_chunk=epoch_chunk)
    pres = [Preprocessor.fit(d, pca_dim=pca_dim, device=device) for d in data]
    transformed = [pre.transform(d) for pre, d in zip(pres, data)]
    model = CoupledVAE(tuple(x.shape[1] for x in transformed),
                       cfg.output_dim, dropout=cfg.dropout, matmul_bf16=True)
    P = np.eye(n, dtype=np.float32)
    F = np.zeros((n, n), np.float32)
    trainer = JamieTrainer(cfg, model, transformed, P, F, device=device)

    # One eager step's FLOPs (forward, backward, clip, Adam), then the
    # fit's initial state back
    idx0, idx1 = trainer.epoch_sampler(
        torch.Generator(device=device).manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        trainer.train_step(idx0[0], idx1[0], 0)
    step_flops = counter.get_total_flops()
    trainer._load(trainer.init_state())

    chunk_fn = trainer._chunk_fn(epoch_chunk)
    chunk_fn().result()   # warm-up, discarded
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(timed_chunks):
        chunk_fn()
    _sync(device)
    dt = time.perf_counter() - t0

    steps = timed_chunks * epoch_chunk * trainer.len_dataloader
    cells_per_sec = steps * trainer.batch_size / dt
    tflops = step_flops * steps / dt / 1e12
    peak = card_bf16_peak(device)
    return {
        'metric': 'snare_seq_train_cells_per_sec_per_chip',
        'value': cells_per_sec,
        'unit': 'cell-samples/s',
        'vs_baseline': cells_per_sec / BASELINE_CELLS_PER_SEC,
        'extra': {
            'train_achieved_tflops': tflops,
            'train_mfu_vs_card_bf16_peak': (None if peak is None
                                            else tflops * 1e12 / peak),
        },
    }


def synth_scglue(cache=True, shapes=SCGLUE_SHAPES):
    """The scGLUE-shaped pair, from the generator time_and_memory uses
    (the same arrays, the same cache). The ATAC arm is binary peaks
    z-scored per column (binarize1=0.05), what the reference's notebooks
    feed JAMIE; JAMIE_BENCH_ATAC=continuous fits the continuous-Gaussian
    variant instead."""
    b1 = (None if os.environ.get('JAMIE_BENCH_ATAC') == 'continuous'
          else 0.05)
    return synthesize(*shapes, seed=0, binarize1=b1, cache=cache)


def scglue_pipeline_once(data, device=None, **overrides):
    """One whole fit_transform of `data`: (the run's record, the fitted
    estimator, its embeddings). `overrides` replace JAMIE options (depth
    cuts); bench.py's are the defaults."""
    from .core.residency import reset_transfer_stats, transfer_stats
    from .estimator import JAMIE

    kw = dict(epoch_chunk=500, log_pd=2000, log_DNN=100_000,
              model_matmul_dtype='bfloat16')
    kw.update(overrides)
    reset_transfer_stats()
    t0 = time.perf_counter()
    jm = JAMIE(device=device, **kw)
    integrated = jm.fit_transform(dataset=data)
    seconds = time.perf_counter() - t0
    xfer = transfer_stats()
    record = {
        'scglue_pipeline_seconds': seconds,
        'scglue_pipeline_vs_ref_cpu': SCGLUE_REF_SECONDS / seconds,
        'epochs_run': jm.epochs_run,
        'phases': getattr(jm, 'phase_timings', {}),
        # what the residency shipped to the card, its dense-bf16
        # equivalent, and the host's read and bf16-cast seconds behind it
        'upload_mb': xfer['bytes'] / 1e6,
        'upload_mb_bf16_equiv': xfer['bf16_equiv_bytes'] / 1e6,
        'host_read_s': xfer['read_s'],
        'host_encode_s': xfer['encode_s'],
    }
    return record, jm, integrated


def scglue_pipeline_noise_controlled(reps=None, data=None, cache=True,
                                     device=None,
                                     on_fit: Optional[Callable] = None,
                                     **overrides) -> dict:
    """The median of `reps` runs (default JAMIE_BENCH_PIPELINE_REPS, else
    3) with the min/max band and every run's record. on_fit(jm,
    integrated) is called after each run, outside its clock."""
    from .core.dtypes import resolve_device
    device = resolve_device(device)   # before generating the data
    if reps is None:
        reps = max(int(os.environ.get('JAMIE_BENCH_PIPELINE_REPS', '3')), 1)
    if data is None:
        data = synth_scglue(cache)
    runs = []
    for _ in range(reps):
        record, jm, integrated = scglue_pipeline_once(data, device,
                                                      **overrides)
        if on_fit is not None:
            on_fit(jm, integrated)
        runs.append(record)
        del jm, integrated
    secs = sorted(r['scglue_pipeline_seconds'] for r in runs)
    med = secs[len(secs) // 2] if reps % 2 else 0.5 * (
        secs[len(secs) // 2 - 1] + secs[len(secs) // 2])
    return {
        'scglue_pipeline_seconds': med,
        'scglue_pipeline_vs_ref_cpu': SCGLUE_REF_SECONDS / med,
        'scglue_pipeline_band_seconds': [secs[0], secs[-1]],
        'scglue_pipeline_band_vs_ref_cpu': [SCGLUE_REF_SECONDS / secs[-1],
                                            SCGLUE_REF_SECONDS / secs[0]],
        'scglue_pipeline_reps': reps,
        # zb5: binary ATAC z-scored per column at 5% density
        'input_variant': os.environ.get('JAMIE_BENCH_ATAC', 'zb5'),
        'runs': runs,
    }


def _report_fit(jm, integrated) -> None:
    """A progress line on stderr: the fit's FOSCTTM and device peak."""
    peak = (torch.cuda.max_memory_allocated(jm.device)
            if jm.device.type == 'cuda' else None)
    print(json.dumps({'scglue_foscttm': float(jm.test_closer(integrated)),
                      'max_memory_allocated': peak,
                      'manual_seed': jm.config.manual_seed,
                      'epochs_run': jm.epochs_run}), flush=True)


def main(device=None, train_kw=None, pipeline_kw=None) -> int:
    """Both legs; prints the one JSON line and returns the exit code."""
    from .core.dtypes import resolve_device
    from .probes import smi_line

    device = resolve_device(device)
    stdout = sys.stdout
    rc = 0
    # stdout holds the one JSON line: the fits' progress prints go to stderr
    with contextlib.redirect_stdout(sys.stderr):
        print(f'device: {smi_line()}', flush=True)
        record = train_leg(device=device, **(train_kw or {}))
        # a pipeline crash keeps this copy of the train metric in the log
        print(json.dumps(record), flush=True)
        if os.environ.get('JAMIE_BENCH_PIPELINE', '1') != '0':
            if device.type == 'cuda':
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            try:
                extra = scglue_pipeline_noise_controlled(
                    device=device, on_fit=_report_fit, **(pipeline_kw or {}))
            except Exception as e:   # report the train metric regardless
                extra = {'scglue_pipeline_error': repr(e)[:200]}
                rc = 1
            record['extra'].update(extra)
    print(json.dumps(record), file=stdout, flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
