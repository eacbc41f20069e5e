"""scGEM parity pipeline: gene expression + DNA methylation, 177 cells.

The counterpart of the repo's `examples/scgem.py`, which mirrors the
reference's scGEM notebook (scGEM.ipynb): per-feature z-scoring, JAMIE
with the notebook's kwargs (cell 5), full / 75% / 50% priors, the 80/20
imputation split, FOSCTTM + LTA + JS metrics. The same functions,
defaults, `KWARGS`, numpy draws (`np.random.seed(42)` before the prior
masks and the split) and record keys; sklearn's `scale` is
`_data.scale`. Every function takes `data_dir` (default `DATA`, the
repository's examples/data/UnionCom/scGEM/, the example's layout),
`device` (default: the CUDA card) and `cuts`, JAMIE kwargs set over the
example's (a smoke run's epoch cuts).

Reference committed outputs (scGEM.ipynb cell 25): FOSCTTM 0.00680, LTA
0.8870; LTA at 75% / 50% priors: 0.8362 / 0.7966.

    python -m jamie_tpu_torch.examples.scgem [--quick] [--seeds K |
        --imputation-seeds K [--reference-split] | --ablation-seeds K]
        [--data-dir DIR] [--device cpu] [--epoch-dnn N --min-epochs N]
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ._data import (DATA_ROOT, cuts_of, fit_kwargs, parser, require,
                    scale_f32)

DATA = os.path.join(DATA_ROOT, 'UnionCom', 'scGEM', '')

KWARGS = dict(
    output_dim=32, epoch_DNN=10000, min_epochs=2500, log_DNN=500,
    use_early_stop=True, batch_size=128, pca_dim=None,
    dist_method='euclidean', loss_weights=(1, 1, 1, 1), dropout=0,
    epoch_chunk=500,
)
QUICK = dict(epoch_DNN=2000, min_epochs=500, epoch_pd=500)


def load_scgem(data_dir: str = DATA):
    """([expression, methylation] float32 z-scored, [type1, type2] ints)."""
    from ..io import load_matrix
    path = os.path.join(data_dir, 'GeneExpression.txt')
    require(path, 'scGEM', data_dir)
    data1, data2, type1, type2 = (
        load_matrix(os.path.join(data_dir, name), dtype=np.float64)
        for name in ('GeneExpression.txt', 'DNAmethylation.txt',
                     'type1.txt', 'type2.txt'))
    return ([scale_f32(data1), scale_f32(data2)],
            [type1.astype(int), type2.astype(int)])


def reference_js_distance_mean(true, pred, labs, label_order):
    """Mean Jensen-Shannon DISTANCE over (label, feature) pairs, exactly as
    the notebook's plot_distribution_similarity prints it (per-label
    per-feature JS between measured and imputed test cells; NaN ->
    distance 1; any exception, e.g. a label absent from the test subset,
    -> distance 0; the printed 'Mean' is 1 - mean(similarities))."""
    from ..utils import jensen_shannon_from_array
    sims = []
    for lab in label_order:
        for f in range(true.shape[1]):
            try:
                d = jensen_shannon_from_array(
                    [true[labs == lab, f], pred[labs == lab, f]])
                if np.isnan(d):
                    d = 1.0
            except Exception:
                d = 0.0
            sims.append(1.0 - d)
    return 1.0 - float(np.mean(sims))


def _imputation_metrics(jm_im, dataset, types, test_idx):
    """Per-feature Pearson r + reference-semantics mean JS distance for both
    modalities of a trained 80/20 imputation model."""
    out = {}
    imputed = [jm_im.modal_predict(dataset[(i + 1) % 2], (i + 1) % 2)
               for i in range(2)]
    label_order = np.unique(np.concatenate([np.asarray(t) for t in types]))
    for i in range(2):
        pred = imputed[i][test_idx]
        true = dataset[i][test_idx]
        rs = [np.corrcoef(pred[:, j], true[:, j])[0, 1]
              for j in range(true.shape[1]) if np.std(true[:, j]) > 0]
        out[f'imputation_r_mod{i + 1}'] = round(float(np.nanmean(rs)), 4)
        out[f'imputation_js_dist_mod{i + 1}'] = round(
            reference_js_distance_mean(true, pred,
                                       np.asarray(types[i])[test_idx],
                                       label_order), 4)
    return out


def _without_dropout(kwargs):
    return {k: v for k, v in kwargs.items() if k != 'dropout'}


def imputation_multi_seed(n_seeds: int = 5, quick: bool = False,
                          reference_split: bool = False,
                          data_dir: str = DATA, device=None,
                          cuts: dict = None):
    """80/20-split imputation metrics over n_seeds seeds: mean +- sd of
    per-feature r and mean JS distance per modality. reference_split: the
    notebook's split (np.random.seed(42), then train_idx is the first
    draw) for every seed, so only the model seed varies."""
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(device)
    dataset, types = load_scgem(data_dir)
    n = len(dataset[0])
    kwargs = fit_kwargs(KWARGS, quick, QUICK, cuts or {})

    per = {}
    t0 = time.perf_counter()
    for seed in range(n_seeds):
        np.random.seed(42 if reference_split else seed)
        train_idx = np.random.choice(n, int(0.8 * n), replace=False)
        test_idx = np.array(sorted(set(range(n)) - set(train_idx)))
        jm_im = JAMIE(manual_seed=seed, device=device,
                      **_without_dropout(kwargs))
        jm_im.fit_transform(dataset=[d[train_idx] for d in dataset])
        m = _imputation_metrics(jm_im, dataset, types, test_idx)
        print(f'seed {seed}:', json.dumps(m), flush=True)
        for k, v in m.items():
            per.setdefault(k, []).append(v)

    results = {'n_seeds': n_seeds,
               'total_seconds': round(time.perf_counter() - t0, 1)}
    for k, v in per.items():
        results[k + '_mean'] = round(float(np.mean(v)), 4)
        results[k + '_sd'] = round(float(np.std(v)), 4)
        results[k + '_runs'] = v
    results['reference'] = {'imputation_js_dist_mod1': 0.4726,
                            'imputation_js_dist_mod2': 0.5317,
                            'note': 'committed cell-29 Mean prints are mean '
                                    'JS distances (lower better)'}
    print(json.dumps(results, indent=2))
    return results


def multi_seed(n_seeds: int = 5, quick: bool = False, data_dir: str = DATA,
               device=None, cuts: dict = None):
    """Full + partial-prior quality over n_seeds independent seeds
    (mean +- sd)."""
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(device)
    dataset, types = load_scgem(data_dir)
    n = len(dataset[0])
    kwargs = fit_kwargs(KWARGS, quick, QUICK, cuts or {})

    per_seed = {'foscttm': [], 'lta': [], 'lta_75': [], 'lta_50': []}
    t0 = time.perf_counter()
    for seed in range(n_seeds):
        np.random.seed(seed)
        jm = JAMIE(manual_seed=seed, device=device, **kwargs)
        jm.fit_transform(dataset=dataset)
        jm_data = jm.transform(dataset=dataset)
        per_seed['foscttm'].append(jm.test_closer(jm_data))
        per_seed['lta'].append(jm.test_LabelTA(jm_data, types))
        for frac, name in ((0.75, 'lta_75'), (0.5, 'lta_50')):
            idx = np.random.choice(n, int(frac * n), replace=False)
            mask = np.zeros(n)
            mask[idx] = 1
            jm_p = JAMIE(manual_seed=seed, device=device, **kwargs)
            jm_p.fit_transform(dataset=dataset, P=np.diag(mask))
            p_data = jm_p.transform(dataset=dataset)
            per_seed[name].append(jm_p.test_LabelTA(p_data, types))
        print(f'seed {seed}: ' + ' '.join(
            f'{k}={per_seed[k][-1]:.4f}' for k in per_seed))

    results = {'n_seeds': n_seeds,
               'total_seconds': round(time.perf_counter() - t0, 1)}
    for k, v in per_seed.items():
        results[k + '_mean'] = round(float(np.mean(v)), 5)
        results[k + '_sd'] = round(float(np.std(v)), 5)
        results[k + '_runs'] = [round(float(x), 5) for x in v]
    results['reference'] = {'foscttm': 0.00680, 'lta': 0.8870,
                            'lta_75': 0.8362, 'lta_50': 0.7966}
    print(json.dumps(results, indent=2))
    return results


def ablation(n_seeds: int = 5, quick: bool = False, data_dir: str = DATA,
             device=None, cuts: dict = None):
    """Per-knob quality ablation: the full-config fit (FOSCTTM + LTA) at
    n_seeds seeds for each arm of the example (default; prng_impl='rbg',
    which only steers jamie_tpu's TPU build and is inert here;
    model_matmul_dtype='bfloat16'; both)."""
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(device)
    dataset, types = load_scgem(data_dir)
    kwargs = fit_kwargs(KWARGS, quick, QUICK, cuts or {})

    arms = {
        'default': {},
        'rbg': {'prng_impl': 'rbg'},
        'bf16': {'model_matmul_dtype': 'bfloat16'},
        'rbg+bf16': {'prng_impl': 'rbg', 'model_matmul_dtype': 'bfloat16'},
    }
    results = {'n_seeds': n_seeds,
               'reference': {'foscttm': 0.00680, 'lta': 0.8870}}
    t0 = time.perf_counter()
    for arm, extra in arms.items():
        fos, lta = [], []
        for seed in range(n_seeds):
            jm = JAMIE(manual_seed=seed, device=device, **{**kwargs, **extra})
            jm.fit_transform(dataset=dataset)
            jm_data = jm.transform(dataset=dataset)
            fos.append(float(jm.test_closer(jm_data)))
            lta.append(float(jm.test_LabelTA(jm_data, types)))
        results[arm] = {
            'foscttm_mean': round(float(np.mean(fos)), 5),
            'foscttm_sd': round(float(np.std(fos)), 5),
            'lta_mean': round(float(np.mean(lta)), 5),
            'lta_sd': round(float(np.std(lta)), 5),
            'lta_runs': [round(v, 5) for v in lta],
        }
        print(f'arm {arm}:', json.dumps(results[arm]), flush=True)
    results['total_seconds'] = round(time.perf_counter() - t0, 1)
    print(json.dumps(results, indent=2))
    return results


def main(quick: bool = False, data_dir: str = DATA, device=None,
         cuts: dict = None):
    """The notebook's run: the full-prior fit, the 75% / 50% diag priors
    and the 80/20 imputation split."""
    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(device)
    np.random.seed(42)
    dataset, types = load_scgem(data_dir)
    n = len(dataset[0])
    kwargs = fit_kwargs(KWARGS, quick, QUICK, cuts or {})

    results = {}

    # Full-correspondence integration (notebook cell 8)
    t0 = time.perf_counter()
    jm = JAMIE(device=device, **kwargs)
    jm.fit_transform(dataset=dataset)
    jm_data = jm.transform(dataset=dataset)
    results['fit_seconds'] = round(time.perf_counter() - t0, 1)
    results['foscttm'] = round(jm.test_closer(jm_data), 5)
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

    # Imputation on an 80/20 split (cell 11), per-feature pearson r
    train_idx = np.random.choice(n, int(0.8 * n), replace=False)
    test_idx = np.array(sorted(set(range(n)) - set(train_idx)))
    jm_im = JAMIE(device=device, **_without_dropout(kwargs))
    jm_im.fit_transform(dataset=[d[train_idx] for d in dataset])
    results.update(_imputation_metrics(jm_im, dataset, types, test_idx))

    results['reference'] = {
        'foscttm': 0.00680, 'lta': 0.8870,
        'lta_75': 0.8362, 'lta_50': 0.7966,
    }
    print(json.dumps(results, indent=2))
    return results


if __name__ == '__main__':
    ap = parser(__doc__, DATA)
    group = ap.add_mutually_exclusive_group()
    group.add_argument('--seeds', type=int, default=None)
    group.add_argument('--imputation-seeds', type=int, default=None)
    group.add_argument('--ablation-seeds', type=int, default=None)
    ap.add_argument('--reference-split', action='store_true')
    args = ap.parse_args()
    common = dict(quick=args.quick, data_dir=args.data_dir,
                  device=args.device, cuts=cuts_of(args))
    if args.ablation_seeds is not None:
        ablation(n_seeds=args.ablation_seeds, **common)
    elif args.imputation_seeds is not None:
        imputation_multi_seed(n_seeds=args.imputation_seeds,
                              reference_split=args.reference_split, **common)
    elif args.seeds is not None:
        multi_seed(n_seeds=args.seeds, **common)
    else:
        main(**common)
