"""Imputation method comparison (the reference's DM_rep4-Imp.ipynb shape):
a train/test split; JAMIE's cross-modal imputation against kNN regression
and the simple-NN baseline; the per-feature correlation and AUROC figure
and a summary JSON.

The counterpart of the repo's `examples/imputation_comparison.py`, both
arms. The synthetic default arm: the same split (numpy's global generator
seeded 42), the same JAMIE settings, `predict_knn` and
`predict_nn(epochs=50)` both ways, the same mean per-feature r on the test
cells. One deviation: the example imports matplotlib unconditionally; here
the figure is drawn where matplotlib is installed and `figure` is null
otherwise. The `--scgem` arm (`scgem_multi_seed`): JAMIE vs kNN vs
simple-NN per-feature Pearson r on the held-out cells of the real scGEM
80/20 split, over `--seeds` splits, read from `--data-dir` (default: the
repository's examples/data/UnionCom/scGEM/; the data is not there yet).

    python -m jamie_tpu_torch.examples.imputation_comparison [--device cpu]
    python -m jamie_tpu_torch.examples.imputation_comparison --scgem
        [--seeds K] [--quick] [--data-dir DIR] [--device cpu]
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

from . import scgem
from ._data import cuts_of, fit_kwargs, parser
from .sample import default_out_dir, make_branching_pair


def split(n: int):
    """(train_idx, test_idx): the example's 80/20 split of n cells."""
    np.random.seed(42)
    train_idx = np.random.choice(n, int(0.8 * n), replace=False)
    test_idx = np.array(sorted(set(range(n)) - set(train_idx)))
    return train_idx, test_idx


def main(out_dir: Optional[str] = None, device=None, n: int = 400,
         epoch_DNN: int = 2000, min_epochs: int = 500, epoch_pd: int = 500,
         nn_epochs: int = 50, on_fit: Optional[Callable] = None) -> dict:
    """The comparison; n and the epochs cut it to size (the defaults are
    the example's). on_fit(jm, integrated, train) runs right after the
    fit on the train rows."""
    from ..core.dtypes import resolve_device
    from ..estimator import JAMIE
    from ..models.baselines import predict_nn
    from ..utils import predict_knn

    device = resolve_device(device)   # before any work
    dataset, _types = make_branching_pair(n=n)
    n = len(dataset[0])
    train_idx, test_idx = split(n)

    jm = JAMIE(epoch_DNN=epoch_DNN, min_epochs=min_epochs, epoch_pd=epoch_pd,
               batch_size=128, pca_dim=(64, 64), log_DNN=100000,
               device=device)
    train = [d[train_idx] for d in dataset]
    integrated = jm.fit_transform(dataset=train)
    if on_fit is not None:
        on_fit(jm, integrated, train)
    jamie_pred = [jm.modal_predict(dataset[(i + 1) % 2], (i + 1) % 2)
                  for i in range(2)]

    knn_pred = [
        predict_knn(train[1], train[0], val=dataset[1], device=device),
        predict_knn(train[0], train[1], val=dataset[0], device=device),
    ]
    nn_pred = [
        predict_nn(train[1], train[0], val=dataset[1], epochs=nn_epochs,
                   device=device),
        predict_nn(train[0], train[1], val=dataset[0], epochs=nn_epochs,
                   device=device),
    ]

    def mean_r(pred, i):
        p, t = pred[i][test_idx], dataset[i][test_idx]
        rs = [np.corrcoef(p[:, j], t[:, j])[0, 1]
              for j in range(t.shape[1]) if np.std(t[:, j]) > 0]
        return float(np.nanmean(rs))

    results = {
        'jamie_r': [mean_r(jamie_pred, 0), mean_r(jamie_pred, 1)],
        'knn_r': [mean_r(knn_pred, 0), mean_r(knn_pred, 1)],
        'nn_r': [mean_r(nn_pred, 0), mean_r(nn_pred, 1)],
        'figure': None,
    }
    try:
        import matplotlib
    except ImportError as e:
        print('plotting skipped:', e)
    else:
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        from ..evaluation import plot_auroc_correlation
        test_data = [d[test_idx] for d in dataset]
        test_imputed = [
            [jamie_pred[0][test_idx], jamie_pred[1][test_idx]],
            [knn_pred[0][test_idx], knn_pred[1][test_idx]],
        ]
        plt.figure(figsize=(9, 4))
        plot_auroc_correlation(test_imputed, test_data,
                               ['Modality 1', 'Modality 2'],
                               names=['JAMIE', 'kNN'])
        out_dir = out_dir or default_out_dir('imputation_comparison')
        os.makedirs(out_dir, exist_ok=True)
        results['figure'] = os.path.join(out_dir,
                                         'jamie_imputation_comparison.png')
        plt.savefig(results['figure'], dpi=100)
        plt.close('all')
    print(json.dumps(results, indent=2))
    return results


def scgem_multi_seed(n_seeds: int = 5, quick: bool = False,
                     data_dir: str = scgem.DATA, device=None,
                     cuts: dict = None):
    """JAMIE vs kNN vs simple-NN cross-modal imputation on the real scGEM
    80/20 split, n_seeds independent splits. Per-feature Pearson r on test
    cells per modality (higher is better), mean +- sd per method. `cuts`
    is set over the JAMIE kwargs (a smoke run's epoch cuts)."""
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    from ..models.baselines import predict_nn
    from ..utils import predict_knn

    device = resolve_device(device)   # before any work
    dataset, types = scgem.load_scgem(data_dir)
    n = len(dataset[0])
    kwargs = fit_kwargs({k: v for k, v in scgem.KWARGS.items()
                         if k != 'dropout'}, quick, scgem.QUICK, cuts or {})

    def feature_rs(pred, i, test_idx):
        p, t = pred[test_idx], dataset[i][test_idx]
        return np.array([np.corrcoef(p[:, j], t[:, j])[0, 1]
                         for j in range(t.shape[1])
                         if np.std(t[:, j]) > 0])

    per = {}
    t0 = time.perf_counter()
    for seed in range(n_seeds):
        np.random.seed(seed)
        train_idx = np.random.choice(n, int(0.8 * n), replace=False)
        test_idx = np.array(sorted(set(range(n)) - set(train_idx)))
        train = [d[train_idx] for d in dataset]

        jm = JAMIE(manual_seed=seed, device=device, **kwargs)
        jm.fit_transform(dataset=train)
        preds = {
            'jamie': [jm.modal_predict(dataset[(i + 1) % 2], (i + 1) % 2)
                      for i in range(2)],
            'knn': [predict_knn(train[1], train[0], val=dataset[1],
                                device=device),
                    predict_knn(train[0], train[1], val=dataset[0],
                                device=device)],
            'nn': [predict_nn(train[1], train[0], val=dataset[1],
                              epochs=200, seed=seed, device=device),
                   predict_nn(train[0], train[1], val=dataset[0],
                              epochs=200, seed=seed, device=device)],
        }
        row = {}
        rs = {method: [feature_rs(pr[i], i, test_idx) for i in range(2)]
              for method, pr in preds.items()}
        for method in preds:
            for i in range(2):
                row[f'{method}_r_mod{i + 1}'] = round(
                    float(np.nanmean(rs[method][i])), 4)
        # the reference figure's sign test (scGEM-Imp*.svg annotations):
        # features where JAMIE's per-feature r beats the baseline's
        for base in ('knn', 'nn'):
            for i in range(2):
                a, b = rs['jamie'][i], rs[base][i]
                row[f'jamie_gt_{base}_mod{i + 1}'] = (
                    f'{int(np.nansum(a > b))}/{int(np.nansum(b > a))}')
        print(f'seed {seed}:', json.dumps(row), flush=True)
        for k, v in row.items():
            per.setdefault(k, []).append(v)

    results = {'n_seeds': n_seeds, 'dataset': 'scGEM (real, 80/20)',
               'total_seconds': round(time.perf_counter() - t0, 1)}
    for k, v in per.items():
        if isinstance(v[0], str):     # sign-count strings: runs only
            results[k + '_runs'] = v
            continue
        results[k + '_mean'] = round(float(np.mean(v)), 4)
        results[k + '_sd'] = round(float(np.std(v)), 4)
        results[k + '_runs'] = v
    print(json.dumps(results, indent=2))
    return results


if __name__ == '__main__':
    ap = parser(__doc__, scgem.DATA)
    ap.add_argument('--scgem', action='store_true',
                    help='the real scGEM arm, read from --data-dir')
    ap.add_argument('--seeds', type=int, default=5)
    ap.add_argument('--out-dir', default=None)
    args = ap.parse_args()
    if args.scgem:
        scgem_multi_seed(n_seeds=args.seeds, quick=args.quick,
                         data_dir=args.data_dir, device=args.device,
                         cuts=cuts_of(args))
    else:
        main(out_dir=args.out_dir, device=args.device)
