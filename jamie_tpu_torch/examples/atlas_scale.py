"""Atlas-scale demo: 100,000 cells and more, the N x N prior implicit.

The counterpart of the repo's `examples/atlas_scale.py` (BASELINE.json
config 5, "Atlas-scale 10x Multiome RNA+ATAC (100k+ cells)"), with the same
flags and defaults. Two modes:

- default: the PCA-space trainer on `make_multiome` (bit-equal draws),
  P the 'identity' sentinel or, with `--sparse-prior F`, a `SparseRows`
  diagonal over a fraction F of the cells (hybrid sampling, no N^2), F
  'zeros', dropout 0.6; under `--mesh` the batches shard over a
  `create_mesh()` when the process group has more than one rank;
- `--sparse-data`: raw CSR modalities (`synth.synthesize_sparse_pair`)
  through `JAMIE` with a landmark F, the exact row-blocked FOSCTTM and the
  label transfer on a `--metric-cells` subsample.

Each prints one JSON record with the example's keys, unrounded. `devices`
is the process group's world size, else the CUDA device count, and `hbm`
is `core.timing.device_memory_stats()`. The --sparse-data record adds the
host generation time (`generate_seconds`). The example's SIGTERM stack
dump served a remote TPU link and is not kept.

    python -m jamie_tpu_torch.examples.atlas_scale [--cells 100000]
        [--epochs 100] [--sparse-prior F] [--sparse-data] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import numpy as np


def make_multiome(n=100_000, d_rna=512, d_atac=512, seed=0):
    """PCA-space multiome-like data (atlas pipelines PCA first; generating
    post-PCA keeps the demo's memory footprint honest for the train loop)."""
    rng = np.random.RandomState(seed)
    k = 24
    z = rng.randn(n, k).astype(np.float32)
    centers = 2 * rng.randn(12, k).astype(np.float32)
    z += centers[rng.randint(0, 12, n)]
    rna = z @ rng.randn(k, d_rna).astype(np.float32) \
        + 0.5 * rng.randn(n, d_rna).astype(np.float32)
    atac = z @ rng.randn(k, d_atac).astype(np.float32) \
        + 0.5 * rng.randn(n, d_atac).astype(np.float32)
    return [rna, atac]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cells', type=int, default=100_000)
    ap.add_argument('--epochs', type=int, default=100)
    ap.add_argument('--batch-size', type=int, default=512)
    ap.add_argument('--mesh', action='store_true',
                    help='shard over every rank of the process group')
    ap.add_argument('--sparse-prior', type=float, default=None, metavar='F',
                    help='partial prior: fraction F of cells matched, as a '
                         'SparseRows diagonal (hybrid sampling, no N^2)')
    ap.add_argument('--sparse-data', action='store_true',
                    help='raw-feature sparse CSR modalities through the '
                         'full estimator (streamed PCA + landmark F) '
                         'instead of the PCA-space trainer demo')
    ap.add_argument('--features', type=int, nargs=2, default=(20000, 40000),
                    metavar=('D_RNA', 'D_ATAC'),
                    help='raw feature widths for --sparse-data')
    ap.add_argument('--density', type=float, default=0.03,
                    help='nonzero fraction of the synthetic CSR modalities '
                         '(10x multiome RNA is ~5-10%%, ATAC ~1-3%%)')
    ap.add_argument('--landmarks', type=int, default=2048,
                    help='landmark count for --sparse-data correspondence '
                         '(forced: the dense N^2 solver is the wall this '
                         'demo exists to avoid)')
    ap.add_argument('--epoch-pd', type=int, default=2000,
                    help='prime-dual iterations on the landmark subproblem')
    ap.add_argument('--metric-cells', type=int, default=None,
                    help='evaluate LTA on a uniform subsample of this many '
                         'cells (FOSCTTM stays exact at full N)')
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the host (default: the CUDA card)")
    return ap


def _devices(device) -> int:
    import torch
    if torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return torch.cuda.device_count() if device.type == 'cuda' else 1


def _peak_rss_gb():
    """Peak host RSS (GB) from the kernel's accounting."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main_sparse_data(args, cache=True,
                     on_fit: Optional[Callable] = None) -> dict:
    """Raw-feature sparse CSR modalities into the public estimator:
    row-streamed PCA (never densified on the host), landmark
    correspondence, the implicit identity prior, resident post-PCA
    training. FOSCTTM is exact; the label transfer runs on a row subsample
    past --metric-cells (its kNN vote grows as N^2 k)."""
    from ..core.dtypes import resolve_device
    from ..core.residency import transfer_stats
    from ..core.timing import device_memory_stats
    from ..estimator import JAMIE
    from ..evaluation import knn_label_transfer_accuracy, test_closer
    from ..synth import synthesize_sparse_labels, synthesize_sparse_pair

    device = resolve_device(args.device)   # before generating the data
    n = args.cells
    t0 = time.perf_counter()
    rna, atac = synthesize_sparse_pair(n, *args.features,
                                       density=args.density, seed=0,
                                       cache=cache)
    generate_s = time.perf_counter() - t0
    pca = min(512, min(args.features) // 2, n // 2)
    jm = JAMIE(epoch_DNN=args.epochs, min_epochs=args.epochs // 2,
               use_early_stop=False, batch_size=args.batch_size,
               pca_dim=(pca, pca), log_DNN=10 ** 9, epoch_chunk=20,
               corr_landmarks=min(args.landmarks, n),
               epoch_pd=args.epoch_pd,
               use_mesh=True if args.mesh else None,   # None = auto
               device=device)
    t0 = time.perf_counter()
    emb = jm.fit_transform(dataset=[rna, atac])
    fit_s = time.perf_counter() - t0
    if on_fit is not None:
        on_fit(jm, emb, [rna, atac])

    t1 = time.perf_counter()
    f = test_closer(emb, device=device)   # exact, in row blocks
    labels = synthesize_sparse_labels(n, seed=0)   # the latent's clusters
    lta_cells = n
    if args.metric_cells and args.metric_cells < n:
        lta_cells = args.metric_cells
        sub = np.random.RandomState(0).choice(n, lta_cells, replace=False)
        emb_l = [np.asarray(e)[sub] for e in emb]
        labels_l = labels[sub]
    else:
        emb_l, labels_l = emb, labels
    lta, k = knn_label_transfer_accuracy(emb_l, [labels_l, labels_l],
                                         device=device)
    record = {
        'cells': n,
        'features': list(args.features),
        'nnz_frac': (rna.nnz + atac.nnz) / (n * sum(args.features)),
        'devices': _devices(device),
        'generate_seconds': generate_s,
        'fit_seconds': fit_s,
        'phase_seconds': getattr(jm, 'phase_timings', None),
        'mapping_seconds': {k_: float(v) for k_, v in getattr(
            jm, '_mapping_timings', {}).items()},
        'foscttm_exact': float(f),
        'label_transfer_acc': float(lta),
        'label_transfer_k': int(k),
        'label_transfer_cells': int(lta_cells),
        'metric_seconds': time.perf_counter() - t1,
        'hbm': device_memory_stats(device),
        'peak_rss_gb': _peak_rss_gb(),
        'transfer': {k_: (v if isinstance(v, float) else v / 1e6)
                     for k_, v in transfer_stats().items()},
    }
    print(json.dumps(record))
    return record


def main(argv=None, cache=True, on_fit: Optional[Callable] = None) -> dict:
    """Parse `argv` (sys.argv by default), run the mode it names, print and
    return its record. cache: where --sparse-data keeps its generated
    pair (`synth`'s `cache`; False generates in memory). on_fit(jm,
    embeddings, dataset) runs right after the --sparse-data fit."""
    args = parser().parse_args(argv)
    if args.sparse_data:
        return main_sparse_data(args, cache=cache, on_fit=on_fit)

    import torch

    from ..config import JamieConfig
    from ..core.dtypes import resolve_device
    from ..core.mesh import create_mesh
    from ..core.timing import device_memory_stats
    from ..models import CoupledVAE
    from ..train.trainer import JamieTrainer

    device = resolve_device(args.device)
    data = make_multiome(args.cells)
    mesh = (create_mesh() if args.mesh and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1 else None)

    if args.sparse_prior is not None:
        from ..ops.sparse import SparseRows
        rng = np.random.RandomState(1)
        on = rng.choice(args.cells, int(args.sparse_prior * args.cells),
                        replace=False)
        P = SparseRows.from_coo(on, on, np.ones(len(on), np.float32),
                                (args.cells, args.cells))
    else:
        P = 'identity'

    cfg = JamieConfig(epoch_DNN=args.epochs, min_epochs=args.epochs // 2,
                      batch_size=args.batch_size, use_early_stop=False,
                      pca_dim=None, log_DNN=10 ** 9, epoch_chunk=20)
    model = CoupledVAE((data[0].shape[1], data[1].shape[1]), cfg.output_dim,
                       dropout=0.6)
    trainer = JamieTrainer(cfg, model, data, P, 'zeros', device=device,
                           mesh=mesh)

    t0 = time.perf_counter()
    state = trainer.fit()
    fit_s = time.perf_counter() - t0
    steps = trainer.epochs_run * trainer.len_dataloader
    emb = trainer.final_embed(state)

    record = {
        'cells': args.cells,
        'devices': _devices(device),
        'sampling': trainer.sampling_method,
        'epochs': trainer.epochs_run,
        'fit_seconds': fit_s,
        'cell_samples_per_sec': steps * trainer.batch_size / fit_s,
        'embedding_shapes': [list(e.shape) for e in emb],
        'finite': bool(all(np.isfinite(np.asarray(e)).all() for e in emb)),
        'hbm': device_memory_stats(device),
    }
    print(json.dumps(record))
    return record


if __name__ == '__main__':
    main()
