"""scMNC mouse motor cortex parity pipeline: transcriptomics +
electrophysiology, 1208 cells (Patch-seq).

The counterpart of the repo's `examples/scmnc_motor.py`, which mirrors the
reference's scMNC-Motor notebook (scMNC-Motor.ipynb cells 3-5): gene
expression transposed to cells x genes, 29 e-features, per-feature
z-scoring with NaN -> 0, labels = first word of the metadata 'RNA
family', JAMIE with batch_size=256 / pca_dim=[512,512]. The matrices are
read from motor_data_filtered.rda (the port's `rdata.load_rda`): `gdata`
(genes x cells, with dimnames), `edata` (a data.frame whose row names are
the cells) and `meta` ('Cell', 'RNA family'). The rda ships raw counts;
the default transform is the example's median-depth normalize_total +
log1p. The same functions, defaults, `KWARGS`, numpy draws and record
keys; `data_dir`, `device` (default: the CUDA card) and `cuts` (JAMIE
kwargs set over the example's) are the twin's.

Reference committed outputs (scMNC-Motor.ipynb cell 25): FOSCTTM 0.0025,
LTA 0.8957; LTA at 75% / 50% priors: 0.8286 / 0.7599.

    python -m jamie_tpu_torch.examples.scmnc_motor [--quick] [--partial]
        [--seeds K] [--data-dir DIR] [--device cpu]
        [--epoch-dnn N --min-epochs N]
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ._data import (DATA_ROOT, cuts_of, fit_kwargs, parser, require,
                    scale_f32)

DATA = os.path.join(DATA_ROOT, 'scMNC', 'mouse_motor_cortex', 'data', '')

KWARGS = dict(
    output_dim=32, epoch_DNN=10000, min_epochs=2500, log_DNN=500,
    use_early_stop=True, batch_size=256, pca_dim=(512, 512),
    dist_method='euclidean', loss_weights=(1, 1, 1, 1), dropout=0,
    epoch_chunk=500,
)
QUICK = dict(epoch_DNN=3000, min_epochs=1000)
RDA = 'motor_data_filtered.rda'


def median_depth_log1p(x):
    """The shipped transform: scanpy-style median-depth normalize_total,
    then log1p."""
    return np.log1p(x / np.maximum(x.sum(1, keepdims=True), 1.0)
                    * np.median(x.sum(1)))


def load_scmnc_motor(normalize=None, data_dir: str = DATA):
    """normalize: None -> `median_depth_log1p`, or a callable applied to
    the raw cells x genes count matrix (the sweep passes its candidates).
    Returns ([genes, e-features] float32 z-scored, [types, types])."""
    from ..rdata import load_rda
    path = os.path.join(data_dir, RDA)
    require(path, 'scMNC motor', data_dir)
    d = load_rda(path)
    gdata = d['gdata']['matrix']                        # genes x cells
    sample_names = np.asarray(d['gdata']['dimnames'][1])
    edata = d['edata']
    efeat_names = [k for k in edata if k != '__row_names__']
    e_rows = np.asarray(edata['__row_names__'])
    assert (e_rows == sample_names).all()
    data1 = gdata.T.astype(np.float64)                  # cells x genes
    data1 = (normalize or median_depth_log1p)(data1)
    data2 = np.stack([np.asarray(edata[k], np.float64)
                      for k in efeat_names], axis=1)
    meta = d['meta']
    cells = np.asarray(meta['Cell'])
    fam = np.asarray(meta['RNA family'])
    meta_idx = [np.argwhere(cells == s)[0][0] for s in sample_names]
    types = np.array([str(x).split()[0] for x in fam[meta_idx]])
    return [scale_f32(data1), scale_f32(data2)], [types, types]


def multi_seed(n_seeds=3, quick=False, data_dir: str = DATA, device=None,
               cuts: dict = None):
    """Full-prior quality over n_seeds seeds (mean +- sd)."""
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(device)
    dataset, types = load_scmnc_motor(data_dir=data_dir)
    kwargs = fit_kwargs(KWARGS, quick, QUICK, cuts or {})
    per = {'foscttm': [], 'lta': []}
    t0 = time.perf_counter()
    for seed in range(n_seeds):
        np.random.seed(seed)
        jm = JAMIE(manual_seed=seed, device=device, **kwargs)
        jm.fit_transform(dataset=dataset)
        emb = jm.transform(dataset=dataset)
        per['foscttm'].append(jm.test_closer(emb))
        per['lta'].append(jm.test_LabelTA(emb, types))
        print(f'seed {seed}: foscttm={per["foscttm"][-1]:.5f} '
              f'lta={per["lta"][-1]:.4f}')
    results = {'n_seeds': n_seeds,
               'total_seconds': round(time.perf_counter() - t0, 1)}
    for k, v in per.items():
        results[k + '_mean'] = round(float(np.mean(v)), 5)
        results[k + '_sd'] = round(float(np.std(v)), 5)
        results[k + '_runs'] = [round(float(x), 5) for x in v]
    results['reference'] = {'foscttm': 0.0025, 'lta': 0.8957}
    print(json.dumps(results, indent=2))
    return results


def main(quick=False, partial=False, data_dir: str = DATA, device=None,
         cuts: dict = None):
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(device)
    np.random.seed(42)
    dataset, types = load_scmnc_motor(data_dir=data_dir)
    print('shapes:', [d.shape for d in dataset])
    n = len(dataset[0])
    kwargs = fit_kwargs(KWARGS, quick, QUICK, cuts or {})

    results = {}
    t0 = time.perf_counter()
    jm = JAMIE(device=device, **kwargs)
    jm.fit_transform(dataset=dataset)
    results['fit_seconds'] = round(time.perf_counter() - t0, 1)
    jm_data = jm.transform(dataset=dataset)
    results['foscttm'] = round(jm.test_closer(jm_data), 5)
    results['lta'] = round(jm.test_LabelTA(jm_data, types), 4)
    results['epochs_run'] = jm.epochs_run

    if partial:
        for frac, name in ((0.75, 'lta_75'), (0.5, 'lta_50')):
            idx = np.random.choice(n, int(frac * n), replace=False)
            mask = np.zeros(n)
            mask[idx] = 1
            jm_p = JAMIE(device=device, **kwargs)
            jm_p.fit_transform(dataset=dataset, P=np.diag(mask))
            p_data = jm_p.transform(dataset=dataset)
            results[name] = round(jm_p.test_LabelTA(p_data, types), 4)

    results['reference'] = {
        'foscttm': 0.0025, 'lta': 0.8957,
        'lta_75': 0.8286, 'lta_50': 0.7599,
        'cpu_total_seconds': 526.5,
    }
    print(json.dumps(results, indent=2))
    return results


if __name__ == '__main__':
    ap = parser(__doc__, DATA)
    ap.add_argument('--partial', action='store_true')
    ap.add_argument('--seeds', type=int, default=None)
    args = ap.parse_args()
    common = dict(quick=args.quick, data_dir=args.data_dir,
                  device=args.device, cuts=cuts_of(args))
    if args.seeds is not None:
        multi_seed(n_seeds=args.seeds, **common)
    else:
        main(partial=args.partial, **common)
