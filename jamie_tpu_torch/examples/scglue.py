"""scGLUE parity pipeline: RNA + ATAC, 9190 cells (Chen 2019), the
reference's largest committed real-data fit.

The counterpart of the repo's `examples/scglue.py`, which mirrors the
reference's scGLUE notebook (scGLUE.ipynb cells 3-10): the two `.h5ad`
files load through the port's `io.read_h5ad` (h5py), `obs.cell_type`
labels, per-feature z-scoring in float32 with NaN -> 0, JAMIE with the
notebook's kwargs (cell 5: batch 512, pca_dim [512, 512]), full + 75% +
50% diag priors. The loader and the fits are split: `load_scglue`
reads the files, `run` fits arrays (so a machine without h5py runs the
pipeline on arrays it made), and `main` is the two. The same defaults,
`KWARGS`, numpy draws and record keys; `data_dir`, `device` (default: the
CUDA card) and `cuts` (JAMIE kwargs set over the example's) are the
twin's.

Reference committed outputs (scGLUE.ipynb cell 26): FOSCTTM 0.000587, LTA
0.8461; LTA at 75% / 50% priors: 0.6705 / 0.6083.

    python -m jamie_tpu_torch.examples.scglue [--quick] [--data-dir DIR]
        [--device cpu] [--epoch-dnn N --min-epochs N]
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ._data import DATA_ROOT, cuts_of, fit_kwargs, parser

DATA = os.path.join(DATA_ROOT, 'scGLUE', '')

KWARGS = dict(
    output_dim=32, epoch_DNN=10000, min_epochs=2500, log_DNN=500,
    use_early_stop=True, batch_size=512, pca_dim=(512, 512),
    dist_method='euclidean', loss_weights=(1, 1, 1, 1), dropout=0,
    epoch_chunk=500,
)
QUICK = dict(epoch_DNN=2000, min_epochs=500, epoch_pd=500)


def _zscore(x):
    """Per-feature standardization matching the notebook's
    preprocessing.scale(axis=0) + NaN -> 0, computed in float32 (the ATAC
    modality is 9190 x 241757; a float64 pass would copy 17.8 GB)."""
    mean = x.mean(axis=0, dtype=np.float32)
    std = x.std(axis=0, dtype=np.float32)
    std[std == 0] = 1.0
    out = (x - mean) / std
    np.nan_to_num(out, copy=False)
    return out


def load_scglue(data_dir: str = DATA):
    """([RNA, ATAC] z-scored float32, [RNA cell types, ATAC cell types])."""
    from ..io import read_h5ad
    rna_path = os.path.join(data_dir, 'Chen-2019-RNA.h5ad')
    atac_path = os.path.join(data_dir, 'Chen-2019-ATAC.h5ad')
    if not os.path.exists(rna_path):
        print('scGLUE h5ad data not found at', data_dir,
              '(see jamie_tpu_torch.time_and_memory --configs scglue for '
              'the synthetic wall-clock run at this exact shape)')
        raise SystemExit(0)
    rna = read_h5ad(rna_path, obs_columns=['cell_type'],
                    var_columns=['name'])
    atac = read_h5ad(atac_path, obs_columns=['cell_type'])
    dataset = [_zscore(rna.X), _zscore(atac.X)]
    types = [np.asarray(rna.obs['cell_type']),
             np.asarray(atac.obs['cell_type'])]
    return dataset, types


def run(dataset, types, quick: bool = False, device=None,
        cuts: dict = None):
    """The notebook's fits on loaded arrays: the full-prior fit, then the
    75% / 50% diag priors drawn after np.random.seed(42)."""
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(device)
    np.random.seed(42)
    n = len(dataset[0])
    kwargs = fit_kwargs(KWARGS, quick, QUICK, cuts or {})

    results = {}

    # Full-correspondence integration (notebook cell 8)
    t0 = time.perf_counter()
    jm = JAMIE(device=device, **kwargs)
    jm.fit_transform(dataset=dataset)
    jm_data = jm.transform(dataset=dataset)
    results['fit_seconds'] = round(time.perf_counter() - t0, 1)
    results['foscttm'] = round(jm.test_closer(jm_data), 6)
    results['lta'] = round(jm.test_LabelTA(jm_data, types), 4)

    # Partial priors (cells 9-10): diag mask at 75% / 50%
    for frac, name in ((0.75, 'lta_75'), (0.5, 'lta_50')):
        idx = np.random.choice(n, int(frac * n), replace=False)
        mask = np.zeros(n)
        mask[idx] = 1
        jm_p = JAMIE(device=device, **kwargs)
        jm_p.fit_transform(dataset=dataset, P=np.diag(mask))
        p_data = jm_p.transform(dataset=dataset)
        results[name] = round(jm_p.test_LabelTA(p_data, types), 4)

    results['reference'] = {
        'foscttm': 0.000587, 'lta': 0.8461,
        'lta_75': 0.6705, 'lta_50': 0.6083,
        'fit_seconds_cpu': 52557.4,
    }
    print(json.dumps(results, indent=2))
    return results


def main(quick: bool = False, data_dir: str = DATA, device=None,
         cuts: dict = None):
    from ..core.dtypes import resolve_device
    device = resolve_device(device)   # before any work
    dataset, types = load_scglue(data_dir)
    return run(dataset, types, quick=quick, device=device, cuts=cuts)


if __name__ == '__main__':
    args = parser(__doc__, DATA).parse_args()
    main(quick=args.quick, data_dir=args.data_dir, device=args.device,
         cuts=cuts_of(args))
