"""General utilities: triage, hashing, JS distance, tuning, the imputation
baselines and the legacy plots.

Reference parity: `jamie_tpu/utils.py` (jamie/utilities.py). Copied as they
are: `outliers`, `ensure_list`, `reduce_sample_data`, `set_yticks`,
`jensen_shannon_from_array`, `sort_by_interest`, `hash_kwargs` (an exact
output contract: the notebooks use it for cache filenames) and `tune_cm`.
`time_logger` is `core/timing.TimeLogger`, `identity` and `preclass` come
from `preprocess`.

Where jamie_tpu calls sklearn or umap (neither is on the card's machine):

- `jensen_shannon_from_array(normalize=True)` standardizes each sample as
  sklearn's `preprocessing.scale` does, in numpy: ddof 0, and a zero
  standard deviation (below 10 eps for a 2-D sample) taken as 1;
- `predict_knn` is K3 squared distances plus `torch.topk` and the mean of
  the k targets, on `device`, in place of `KNeighborsRegressor`; with
  `val=None` each row counts itself among its neighbours, as sklearn's does;
- the legacy plots embed with this package's PCA, `tsne_embed` and
  `umap_embed` on `device` in place of sklearn's TSNE and the umap package.

matplotlib is imported inside the plotting functions.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from scipy import stats

from .core.dtypes import resolve_device
from .core.timing import TimeLogger as time_logger  # noqa: N813 (ref name)
from .evaluation import _block_rows
from .ops.distances import _as_device_f32
from .ops.pairwise import pairwise_euclidean
from .preprocess import identity  # noqa: F401 (re-export)
from .preprocess import Preprocessor as preclass  # noqa: F401,N813 (ref name)


def outliers(x, leniency=1.5, aggregate=False, return_limits=False,
             verbose=False):
    """Box-and-whisker outlier mask: outside Q1/Q3 -/+ leniency*IQR,
    per column."""
    x = np.asarray(x)
    q1, q3 = np.percentile(x, [25, 75], axis=0, keepdims=True)
    span = q3 - q1
    lo = q1 - leniency * span
    hi = q3 + leniency * span
    if verbose:
        print(f'Lower: {lo}')
        print(f'Upper: {hi}')
    mask = (x < lo) | (x > hi)
    if aggregate:
        mask = np.prod(mask, axis=1)
    if return_limits:
        return mask, (lo, hi, span)
    return mask


def ensure_list(x):
    """Coerce scalars to arrays."""
    if isinstance(x, (np.ndarray, list)):
        return np.array(x)
    return np.array([x])


def reduce_sample_data(df, num_samples=1000, num_features=1000):
    """Keep the highest-variance features of a sparse matrix, with the
    variance estimated on a leading sample (E[x^2] - E[x]^2)."""
    head = df[:num_samples]
    var = head.power(2).mean(axis=0) - np.power(head.mean(axis=0), 2)
    keep = np.squeeze(np.asarray(np.argsort(-var)))[:num_features]
    return df[:, keep]


def set_yticks(ax, num_ticks):
    """Evenly spaced y ticks, inset 10% from each end."""
    lo, hi = ax.get_ylim()
    inset = .1 * (hi - lo)
    ax.set_yticks(np.round(np.linspace(lo + inset, hi - inset, num_ticks), 1))


def _stepwise_pdf(values, grid):
    """Histogram-as-density ('auto' binning) evaluated on `grid`;
    0 outside the observed range (scipy rv_histogram semantics)."""
    counts, edges = np.histogram(values, bins='auto')
    widths = np.diff(edges)
    density = counts / (counts.sum() * widths)
    cell = np.clip(np.searchsorted(edges, grid, side='right') - 1,
                   0, len(density) - 1)
    inside = (grid >= edges[0]) & (grid <= edges[-1])
    return np.where(inside, density[cell], 0.0)


def _scale(d: np.ndarray) -> np.ndarray:
    """sklearn's preprocessing.scale(d, axis=0): centred, divided by the
    ddof-0 standard deviation, a zero one (below 10 eps per column of a
    2-D sample) taken as 1."""
    d = np.asarray(d, d.dtype if d.dtype.kind == 'f' else np.float64)
    std = np.nanstd(d, axis=0)
    if d.ndim == 1:
        std = std if std != 0 else 1.0
    else:
        std = np.where(std < 10 * np.finfo(std.dtype).eps, 1.0, std)
    return (d - np.nanmean(d, axis=0)) / std


def jensen_shannon_from_array(datasets, resolution=1000, normalize=False):
    """JS distance between two samples' distributions: auto-binned histogram
    densities evaluated on a shared grid, then scipy's jensenshannon."""
    from scipy.spatial.distance import jensenshannon
    data = [np.asarray(d) for d in datasets]
    if normalize:
        data = [_scale(d) for d in data]
    grid = np.linspace(min(d.min() for d in data),
                       max(d.max() for d in data), resolution)
    pdfs = [_stepwise_pdf(d, grid) for d in data]
    return jensenshannon(*pdfs)


def _per_column_pearson(a, b):
    """Pearson r between matching columns of a and b (NaN where undefined)."""
    ac = a - a.mean(axis=0)
    bc = b - b.mean(axis=0)
    den = np.sqrt((ac ** 2).sum(axis=0) * (bc ** 2).sum(axis=0))
    with np.errstate(divide='ignore', invalid='ignore'):
        return (ac * bc).sum(axis=0) / den


def sort_by_interest(datasets, int_thresh=.8, limit=20, remove_outliers=True,
                     sort_type='entropy-corr'):
    """Rank (measured, imputed) feature pairs for figure selection.

    Scores per sort_type, then greedily keeps up to `limit` features passing
    the diversity check of the reference (utilities.py:586-600): a candidate
    is skipped only when it correlates *exactly zero* with a kept feature —
    the reference's `all(corr)` truthiness test, preserved for parity.
    Returns (full ranking, selected indices).
    """
    assert sort_type in ('entropy-corr', 'js-mse', 'js', 'mse'), (
        f'Unknown sort type {sort_type}.')
    true, pred = [np.asarray(d) for d in datasets]
    n_feat = true.shape[1]
    limit = n_feat if limit is None else limit

    if sort_type == 'entropy-corr':
        ent = np.zeros(n_feat)
        for i in range(n_feat):
            col = true[:, i]
            if remove_outliers:
                col = col[~outliers(col)]
            hist = np.histogram(
                col, bins=np.linspace(col.min(), col.max(), 100))[0]
            ent[i] = stats.entropy(hist)
        ent[~np.isfinite(ent)] = 0
        corr = _per_column_pearson(true, pred)
        corr = np.where(np.isnan(corr), -1.0, corr)
        ranking = np.argsort(.5 * np.log1p(ent) + corr)[::-1]
    elif sort_type in ('js', 'js-mse'):
        js = [jensen_shannon_from_array([true[:, i], pred[:, i]])
              for i in range(n_feat)]
        ranking = np.argsort(js)
    else:  # 'mse', scaled by the imputed column's std
        with np.errstate(divide='ignore', invalid='ignore'):
            scaled = (true - pred) / pred.std(axis=0)
        mse = np.mean(scaled ** 2, axis=0) * true.shape[0]
        mse = np.where(np.isnan(mse), np.inf, mse)
        ranking = np.argsort(mse)

    selected = []
    for cand in ranking:
        if len(selected) >= limit:
            break
        cross = _per_column_pearson(
            true[:, [cand] * len(selected)], true[:, selected]) \
            if selected else np.array([])
        cross = cross[~np.isnan(cross)]
        if cross.size == 0 or np.all(cross != 0):
            selected.append(int(cand))
    return ranking, np.array(selected)


# Reference defaults the notebooks' cache names are computed against
# (utilities.py:612-624) — a constants table, not logic.
_HASH_DEFAULTS = {
    'output_dim': 32,
    'epoch_DNN': 10000,
    'min_epochs': 2500,
    'log_DNN': 500,
    'use_early_stop': True,
    'batch_size': 512,
    'pca_dim': 2 * [512],
    'dist_method': 'euclidean',
    'loss_weights': [1, 1, 1, 1],
    'use_f_tilde': True,
    'dropout': .6,
}

# str(list-of-kv-pairs) -> filename-safe; order matters (same contract as
# the reference's replace chain, utilities.py:628-631)
_HASH_REWRITES = (
    (' ', ''), ('),', '--'), ('(', ''), (')', ''),
    (',', '-'), ("'", ''), ('[', '('), (']', ')'),
)


def hash_kwargs(kwargs, dataset_name, dataset):
    """Canonical (size_str, hash_str) cache-filename pair: dataset name +
    shapes, plus the sorted non-default kwargs rendered filename-safe."""
    interesting = sorted(
        (k, v) for k, v in kwargs.items()
        if k != 'enable_memory_logging'
        and v != _HASH_DEFAULTS.get(k, object()))
    rendered = str(interesting)[1:-1]
    for old, new in _HASH_REWRITES:
        rendered = rendered.replace(old, new)
    size_str = '---'.join(
        [dataset_name] + ['-'.join(str(s) for s in d.shape)
                          for d in dataset[:2]])
    return size_str, (f'{size_str}---{rendered}' if rendered else size_str)


def tune_cm(cm, dataset, types, wt_size, num_search=20):
    """Random search over loss weights maximizing LTA; returns the best
    weights and their embeddings."""
    draws = np.random.rand(num_search, wt_size)
    best = {'acc': 0, 'wt': None, 'data': None}
    for i, wt in enumerate(draws):
        with contextlib.redirect_stdout(None):
            cm.config = cm.config.replace(loss_weights=tuple(wt))
            cm_data = cm.fit_transform(dataset=dataset)
            acc = cm.test_LabelTA(cm_data, types)
        if acc > best['acc']:
            best = {'acc': acc, 'wt': wt, 'data': cm_data}
        print(f'Done:{100 * (i + 1) / num_search:.1f}%; '
              f'Max:{best["acc"]:.3f}; Curr:{acc:.3f}', end='\r')
    print()
    print(f'Best Weights: {best["wt"]}')
    return best['wt'], best['data']


def predict_knn(input, output, val=None, k=5, device=None):
    """kNN regression imputation baseline: each query row (of `val`, else
    of `input`) gets the mean `output` row of its k nearest `input` rows, by
    K3 squared distances on `device`, in row blocks."""
    device = resolve_device(device)
    fit_x = _as_device_f32(input, device)
    fit_y = _as_device_f32(output, device)
    query = fit_x if val is None else _as_device_f32(val, device)
    k = min(int(k), fit_x.shape[0])
    bs = _block_rows(fit_x.shape[0])
    out = []
    for s in range(0, query.shape[0], bs):
        d = pairwise_euclidean(query[s:s + bs], fit_x, squared=True)
        idx = torch.topk(d, k, dim=1, largest=False).indices
        out.append(fit_y[idx].mean(1).cpu().numpy())
    return np.concatenate(out)


def predict_nn(source, target, val=None, epochs=200, batch_size=32,
               device=None):
    """Simple-NN imputation baseline (models/baselines.py)."""
    from .models.baselines import predict_nn as _predict_nn
    return _predict_nn(source, target, val=val, epochs=epochs,
                       batch_size=batch_size, device=device)


# ---------------------------------------------------------------- legacy viz
def _embed_2d(d, mode, device=None):
    """2-component embedding for the legacy plots on `device`; None = the
    first two columns."""
    from .preprocess import PCA
    if mode == 'PCA':
        return PCA(n_components=2, device=device).fit(d).transform(d)
    if mode == 'TSNE':
        from .solvers.tsne import tsne_embed
        return tsne_embed(d, 2, device=device)
    if mode == 'UMAP':
        from .solvers.umap import umap_embed
        return umap_embed(d, 2, device=device)
    return np.asarray(d)[:, :2]


def visualize_mapping(mapping, primary=0, device=None):
    """Overlay two mappings in the primary mapping's PCA plane."""
    import matplotlib.pyplot as plt
    from .preprocess import PCA
    assert len(mapping) == 2, (
        'Currently, ``visualize_mapping`` only supports 2 mappings')
    plane = PCA(n_components=2, device=device).fit(mapping[primary])
    for i, m in enumerate(mapping):
        pts = plane.transform(m)
        style = dict(s=20, c='orange') if i == primary \
            else dict(s=2, c='blue')
        plt.scatter(pts[:, 0], pts[:, 1], label=f'Mapping {i + 1}', **style)
    plt.title('JAMIE PCA Plot')
    plt.legend(loc='best')


_UC_COLORS = ([1, 0.5, 0], [0.2, 0.4, 0.1], [0.1, 0.2, 0.8],
              [0.5, 1, 0.5], [0.1, 0.8, 0.2])


def uc_visualize(data, data_integrated, datatype=None, mode=None,
                 device=None):
    """UnionCom-style 2-figure integration view: per-dataset panels of the
    raw data, then the joint embedding colored by dataset and by type."""
    import matplotlib.pyplot as plt
    assert mode in ('PCA', 'UMAP', 'TSNE', None), (
        "Mode has to be one of 'PCA', 'UMAP', 'TSNE', or None.")
    n_sets = len(data)
    xl, yl = (f'{mode}-1', f'{mode}-2') if mode else ('NONE-1', 'NONE-2')

    def scatter_by_type(ax_data, types):
        for t in set(types):
            pick = types == t
            plt.scatter(ax_data[pick, 0], ax_data[pick, 1], s=5., alpha=0.8)

    # Figure 1: each raw dataset in its own embedding
    plt.figure()
    for i in range(n_sets):
        plt.subplot(1, n_sets, i + 1)
        pts = _embed_2d(data[i], mode, device)
        if datatype is not None:
            scatter_by_type(pts, np.asarray(datatype[i]))
        else:
            plt.scatter(pts[:, 0], pts[:, 1], s=5.)
        plt.title(f'data{i + 1}')
        plt.xlabel(xl)
        plt.ylabel(yl)
    plt.tight_layout()

    # Figure 2: the joint embedding, split back per dataset
    joint = _embed_2d(np.vstack(data_integrated), mode, device)
    bounds = np.cumsum([0] + [d.shape[0] for d in data_integrated])
    per_set = [joint[bounds[i]:bounds[i + 1]] for i in range(n_sets)]

    plt.figure()
    n_panels = 2 if datatype is not None else 1
    plt.subplot(1, n_panels, 1)
    for i, pts in enumerate(per_set):
        plt.scatter(pts[:, 0], pts[:, 1], c=[_UC_COLORS[i]], s=5., alpha=0.8)
    plt.title('Integrated Embeddings')
    plt.xlabel(xl)
    plt.ylabel(yl)
    if datatype is not None:
        plt.subplot(1, 2, 2)
        scatter_by_type(joint, np.hstack(datatype))
        plt.title('Integrated Cell Types')
        plt.xlabel(xl)
        plt.ylabel(yl)
    plt.tight_layout()
