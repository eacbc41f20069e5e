"""scMNC mouse visual cortex parity pipeline: transcriptomics +
electrophysiology, 3654 cells (Patch-seq).

The counterpart of the repo's `examples/scmnc_visual.py`, which mirrors
the reference's scMNC-Visual notebook (scMNC-Visual.ipynb cells 3-5):
gene-expression matrix transposed to cells x genes, e-features from
column 3 on, per-feature z-scoring with NaN -> 0, labels = first word of
the metadata's t_type, JAMIE with batch_size=512 / pca_dim=[512,512]. The
three CSV files are read with the standard library's `csv` module
(`_data.read_csv`, pandas' missing-value strings as NaN): the gene
expression with the samples as columns after a gene-name column, the
e-features with the sample in column 0 and the features from column 3 on,
and the metadata's `transcriptomics_sample_id` and `t_type` columns. The
same functions, defaults, `KWARGS`, numpy draws and record keys;
`data_dir`, `device` (default: the CUDA card) and `cuts` (JAMIE kwargs
set over the example's) are the twin's.

Reference committed outputs (scMNC-Visual.ipynb cell 25): FOSCTTM
0.00264, LTA 0.9502; LTA at 75% / 50% priors: 0.9031 / 0.8623.

    python -m jamie_tpu_torch.examples.scmnc_visual [--quick] [--partial]
        [--data-dir DIR] [--device cpu] [--epoch-dnn N --min-epochs N]
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ._data import (DATA_ROOT, cuts_of, fit_kwargs, parser, read_csv,
                    require, scale_f32, to_float)

DATA = os.path.join(DATA_ROOT, 'scMNC', 'mouse_visual_cortex', 'data',
                    '')

KWARGS = dict(
    output_dim=32, epoch_DNN=10000, min_epochs=2500, log_DNN=500,
    use_early_stop=True, batch_size=512, pca_dim=(512, 512),
    dist_method='euclidean', loss_weights=(1, 1, 1, 1), dropout=0,
    epoch_chunk=500,
)
QUICK = dict(epoch_DNN=3000, min_epochs=1000)
FILES = ('geneExp_filtered.csv', 'efeature_filtered.csv',
         '20200711_patchseq_metadata_mouse.csv')


def load_scmnc_visual(data_dir: str = DATA):
    """([genes, e-features] float32 z-scored, [types, types])."""
    genes, efeat, metadata = (os.path.join(data_dir, f) for f in FILES)
    require(genes, 'scMNC visual', data_dir)
    header1, rows1 = read_csv(genes)
    _, rows2 = read_csv(efeat)
    sample_names1 = np.array(header1[1:])
    sample_names2 = np.array([r[0] for r in rows2])
    assert (sample_names1 == sample_names2).all()
    data1 = to_float([r[1:] for r in rows1]).T          # cells x genes
    data2 = to_float([r[3:] for r in rows2])
    header3, rows3 = read_csv(metadata)
    cols = [header3.index(c) for c in ('transcriptomics_sample_id',
                                       't_type')]
    meta = np.array([[r[c] for c in cols] for r in rows3], dtype=object)
    meta_idx = [np.argwhere(meta[:, 0] == sample_names1[i])[0][0]
                for i in range(sample_names1.shape[0])]
    types = np.array([x.split(' ')[0] for x in meta[meta_idx, 1]])
    return [scale_f32(data1), scale_f32(data2)], [types, types]


def main(quick=False, partial=False, data_dir: str = DATA, device=None,
         cuts: dict = None):
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(device)
    np.random.seed(42)
    dataset, types = load_scmnc_visual(data_dir)
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
        'foscttm': 0.00264, 'lta': 0.9502,
        'lta_75': 0.9031, 'lta_50': 0.8623,
        'cpu_total_seconds': 5629.7,
    }
    print(json.dumps(results, indent=2))
    return results


if __name__ == '__main__':
    ap = parser(__doc__, DATA)
    ap.add_argument('--partial', action='store_true')
    args = ap.parse_args()
    main(quick=args.quick, partial=args.partial, data_dir=args.data_dir,
         device=args.device, cuts=cuts_of(args))
