"""Figure suite: the plots every reference notebook draws.

Reference parity: `jamie_tpu/figures.py` (jamie/evaluation.py:135-962),
every name of its `__all__`, on this package's `evaluation`, `preprocess`
and `utils`. Its toolkit:

- `integration_scores` computes the LTA/FOSCTTM table once on device and
  feeds all three method-comparison figures;
- `imputation_feature_scores` computes per-feature AUROC / Pearson r fully
  vectorized (rank-sum AUROC; one pass of column algebra for r) instead of a
  per-feature python loop;
- `_paired_scatter` is the one identity-line panel (scatter or KDE density —
  the density mode covers jamie/evaluation.py:529-545) used by the
  AUROC/correlation/sample figures, with the win/loss sign-test annotation.

Where jamie_tpu calls sklearn or umap (neither is on the card's machine):

- `plot_silhouette` takes its widths from `silhouette_samples`, computed on
  `device`: K3 euclidean distances in row blocks times a one-hot label
  matrix give each row's per-cluster distance sums, then a = the mean over
  its own cluster without itself, b = the least mean over another cluster,
  s = (b - a) / max(a, b), and 0 for a singleton cluster, as sklearn's
  `silhouette_samples` defines them;
- method 'umap' embeds with `solvers/umap.umap_embed`, which has no
  out-of-sample transform: `plot_integrated` embeds the concatenated
  modalities once and splits the result by rows (each modality alone with
  `separate_dim`), where jamie_tpu fits the umap package on the
  concatenation and transforms each modality.

The metric computations and reductions run on `device` (the card unless
the caller asks for another). matplotlib, seaborn and pandas are imported
inside the functions that draw or tabulate.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .core.dtypes import resolve_device
from .evaluation import (_block_rows, knn_label_transfer_accuracy,
                         test_closer)
from .ops.distances import _as_device_f32
from .ops.pairwise import pairwise_euclidean

__all__ = [
    'integration_scores', 'imputation_feature_scores',
    'plot_regular', 'plot_integrated', 'plot_accuracy',
    'plot_accuracy_table', 'plot_accuracy_graph', 'plot_silhouette',
    'plot_auroc', 'plot_correlation', 'plot_auroc_correlation',
    'plot_sample', 'plot_distribution', 'plot_distribution_alone',
    'plot_distribution_similarity', 'plot_impact',
    'plot_shap_summary', 'plot_shap_waterfall',
]


# --------------------------------------------------------------------------
# Shared computations
# --------------------------------------------------------------------------
def integration_scores(embeddings_list, labels, names=None, device=None):
    """LTA + FOSCTTM per method -> (pandas DataFrame, k used).

    One device pass per method; every accuracy figure reads this table.
    """
    import pandas as pd
    codes = [np.unique(t, return_inverse=True)[1] for t in labels]
    rows, k_used = [], 5
    for i, emb in enumerate(embeddings_list):
        with contextlib.redirect_stdout(None):
            lta, k_used = knn_label_transfer_accuracy(emb, codes, k=None,
                                                      device=device)
            fos = test_closer(emb, device=device)
        rows.append({'Algorithm': names[i] if names is not None else f'M{i}',
                     'LTA': lta, 'FOSCTTM': fos})
    return pd.DataFrame(rows), k_used


def _binary_auroc_by_column(score: np.ndarray, positive: np.ndarray):
    """Vectorized per-column AUROC via the rank-sum identity.

    score: (N, Fsel) predictions; positive: (N, Fsel) boolean ground truth.
    Columns whose truth is single-class come back NaN (caller drops them).
    """
    from scipy.stats import rankdata
    ranks = rankdata(score, axis=0)          # average ties, like roc_auc_score
    n_pos = positive.sum(axis=0)
    n_neg = positive.shape[0] - n_pos
    rank_sum = np.where(positive, ranks, 0.0).sum(axis=0)
    with np.errstate(divide='ignore', invalid='ignore'):
        auc = (rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    auc[(n_pos == 0) | (n_neg == 0)] = np.nan
    return auc


def _pearson_by_column(pred: np.ndarray, true: np.ndarray):
    """Per-column Pearson r in one pass; constant-truth columns -> NaN."""
    pc = pred - pred.mean(axis=0)
    tc = true - true.mean(axis=0)
    num = (pc * tc).sum(axis=0)
    den = np.sqrt((pc ** 2).sum(axis=0) * (tc ** 2).sum(axis=0))
    with np.errstate(divide='ignore', invalid='ignore'):
        r = num / den
    r[(tc == tc[0]).all(axis=0)] = np.nan
    return r


def imputation_feature_scores(pred, true, kind='pearson',
                              max_features=100_000, rng=None):
    """Per-feature imputation quality scores for one modality.

    kind='auroc' binarizes truth at its global median first (the AUROC
    notebooks' convention); kind='pearson' correlates directly. Returns
    (scores, feature_idx) with NaN columns kept (align multiple methods on
    the same features before dropping).
    """
    pred = np.asarray(pred, np.float64)
    true = np.asarray(true, np.float64)
    n_feat = min(true.shape[1], max_features)
    rng = np.random if rng is None else rng
    feat_idx = rng.choice(true.shape[1], n_feat, replace=False)
    pred, true = pred[:, feat_idx], true[:, feat_idx]
    if kind == 'auroc':
        scores = _binary_auroc_by_column(pred, true > np.median(true))
    elif kind == 'pearson':
        scores = _pearson_by_column(pred, true)
    else:
        raise ValueError(f'unknown score kind {kind!r}')
    return scores, feat_idx


def silhouette_samples(X, labels, device=None) -> np.ndarray:
    """Per-row silhouette width with euclidean distances, sklearn's
    `silhouette_samples(X, labels)` definition, on `device`: each row
    block's K3 distances to every row (its own entries set to exactly 0)
    times the one-hot label matrix give the per-cluster distance sums."""
    device = resolve_device(device)
    x = _as_device_f32(X, device)
    codes = np.unique(np.asarray(labels), return_inverse=True)[1]
    codes_t = torch.as_tensor(codes.reshape(-1), device=device)
    onehot = torch.nn.functional.one_hot(codes_t).to(torch.float32)
    sizes = onehot.sum(0)
    n = x.shape[0]
    bs = _block_rows(n)
    sums = []
    for s in range(0, n, bs):
        d = pairwise_euclidean(x[s:s + bs], x, squared=False)
        rows = torch.arange(d.shape[0], device=device)
        d[rows, s + rows] = 0.0
        sums.append(d @ onehot)
    sums = torch.cat(sums)                                    # (n, clusters)
    own = sizes[codes_t]
    a = sums.gather(1, codes_t[:, None])[:, 0] / torch.clamp(own - 1, min=1)
    mean_other = sums / sizes
    mean_other.scatter_(1, codes_t[:, None], float('inf'))
    b = mean_other.min(1).values
    s = (b - a) / torch.maximum(a, b)
    s = torch.where((own > 1) & torch.isfinite(s), s, 0.0)
    return s.cpu().numpy()


def _sign_test_p(wins: int, n: int) -> float:
    """Two-sided sign test under a fair-coin null (smaller tail doubled)."""
    from scipy.stats import binom
    if n == 0:
        return 1.0
    upper = binom.sf(wins - 1, n, 0.5)
    tail = min(upper, 1.0 - upper)
    return min(2.0 * tail, 1.0)


# --------------------------------------------------------------------------
# Shared panel: identity-line comparison (scatter or density)
# --------------------------------------------------------------------------
def _paired_scatter(ax, x, y, xlabel, ylabel, title=None, annotate=True,
                    plot_type='scatter', color='black', line_style='-',
                    line_color='red'):
    """One square panel comparing paired statistics, with y=x reference.

    plot_type='density' renders a Gaussian-KDE heatmap instead of points
    (the reference template's density branch, jamie/evaluation.py:529-545).
    """
    assert plot_type in ('scatter', 'density')
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    ok = np.isfinite(x) & np.isfinite(y)
    xv, yv = x[ok], y[ok]

    if plot_type == 'scatter':
        ax.scatter(xv, yv, s=3 if len(xv) > 100 else 10,
                   facecolor=color, edgecolor='none')
        ax.axis('square')
    else:
        lo = min(xv.min(), yv.min())
        hi = max(xv.max(), yv.max())
        grid = np.linspace(lo, hi, 300)
        gx, gy = np.meshgrid(grid, grid)
        try:
            from scipy.stats import gaussian_kde
            kde = gaussian_kde(np.stack([xv, yv]))
            dens = kde(np.stack([gx.ravel(), gy.ravel()])).reshape(gx.shape)
        except np.linalg.LinAlgError:
            # Perfectly correlated points make the 2D KDE covariance
            # singular; a binned density carries the same picture.
            dens, _, _ = np.histogram2d(xv, yv, bins=grid)
            gx, gy = np.meshgrid(grid[:-1], grid[:-1])
            dens = dens.T
        ax.pcolormesh(gx, gy, dens, shading='auto', cmap='Greys')
        ax.axis('square')

    if title is not None:
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    span = [max(ax.get_xlim()[0], ax.get_ylim()[0]),
            min(ax.get_xlim()[1], ax.get_ylim()[1])]
    ax.plot(span, span, line_style, color=line_color, alpha=0.75,
            zorder=-1 if line_style == '--' else None)

    if annotate:
        above = int(np.sum(yv > xv))
        below = int(np.sum(xv > yv))
        p = _sign_test_p(above, above + below)
        box = dict(ha='left', va='center', transform=ax.transAxes,
                   backgroundcolor='white')
        ax.text(.05, .9, above, **box)
        box['ha'] = 'right'
        ax.text(.95, .2, below, **box)
        ax.text(.95, .1, f'p-value: {p:.2E}', **box)
    return ax


# --------------------------------------------------------------------------
# Embedding scatter figures
# --------------------------------------------------------------------------
def _reduce(data, method='pca', n_components=2, seed=42, n_neighbors=None,
            separate=False, device=None):
    """2d/3d coordinates of each block of `data`: PCA fit on the
    concatenation (or on each block alone when `separate`) and applied to
    each block; or UMAP ('umap', 'hybrid') of the concatenation split by
    rows (or of each block alone)."""
    from .preprocess import PCA
    fits = ([d] for d in data) if separate else [list(data)]
    pts = []
    for blocks in fits:
        joint = np.concatenate(blocks, axis=0)
        if method in ('umap', 'hybrid'):
            from .solvers.umap import umap_embed
            k = (min(200, joint.shape[0] - 1)
                 if n_neighbors is None else n_neighbors)
            emb = umap_embed(joint, n_components, n_neighbors=k, min_dist=.5,
                             seed=seed, device=device)
            bounds = np.cumsum([0] + [b.shape[0] for b in blocks])
            pts += [emb[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
        else:
            pca = PCA(n_components=n_components, device=device).fit(joint)
            pts += [pca.transform(b) for b in blocks]
    return pts


def plot_integrated(data, labels, names=None, legend=False,
                    remove_outliers=False, n_components=2,
                    hybrid_components=4096, separate_dim=False, square=False,
                    method='umap', n_neighbors=None, seed=42, device=None):
    """Side-by-side scatter of each modality's embedding, colored by label.

    One reduction of the concatenated embeddings (so the two panels live in
    one coordinate system) unless separate_dim; axis limits are unified
    across panels afterwards. 'hybrid' pre-reduces with PCA before UMAP for
    very wide inputs.
    """
    import matplotlib.pyplot as plt
    from .utils import outliers
    assert method in ('pca', 'umap', 'hybrid')
    assert n_components in (2, 3), 'Only supports 2d and 3d at this time.'
    axis_tag = {'pca': 'PC', 'umap': 'UMAP', 'hybrid': 'PC-UMAP'}[method]

    if method == 'hybrid':
        from .preprocess import PCA
        keep = min(hybrid_components, *[min(d.shape) for d in data])
        data = [PCA(n_components=keep, device=device).fit(d).transform(d)
                for d in data]

    fig = plt.gcf()
    label_values = np.unique(np.concatenate(labels))
    panels = []
    reduced = _reduce(data, method, n_components, seed, n_neighbors,
                      separate_dim, device)
    for i, (emb, lab, pts) in enumerate(zip(data, labels, reduced)):
        ax = fig.add_subplot(1, len(data), i + 1,
                             projection='3d' if n_components == 3 else None)
        panels.append(ax)
        drop = outliers(pts) if remove_outliers else None
        for lv in label_values:
            sel = pts[lab == lv]
            if drop is not None:
                sel = np.where(np.any(drop[lab == lv], axis=1,
                                      keepdims=True), np.nan, sel)
            ax.scatter(*sel.T, s=3e3 / emb.shape[0], label=lv)
        if names is not None:
            ax.set_title(names[i])
        if legend and i == len(data) - 1:
            ax.legend()
        ax.set_xlabel(f'{axis_tag}-1')
        ax.set_ylabel(f'{axis_tag}-2')
        if square and n_components == 2:
            ax.set_aspect('equal')

    if not separate_dim:
        xlims = [ax.get_xlim() for ax in panels]
        ylims = [ax.get_ylim() for ax in panels]
        shared_x = (min(l[0] for l in xlims), max(l[1] for l in xlims))
        shared_y = (min(l[0] for l in ylims), max(l[1] for l in ylims))
        for ax in panels:
            ax.set_xlim(shared_x)
            ax.set_ylim(shared_y)


def plot_regular(*args, **kwargs):
    """Raw-modality panels: like plot_integrated but each panel reduced in
    its own space (the modalities share no coordinates before fitting)."""
    plot_integrated(*args, **kwargs, separate_dim=True)


# --------------------------------------------------------------------------
# Method-comparison accuracy figures
# --------------------------------------------------------------------------
def plot_accuracy(data, labels, names, colors=None, device=None):
    """Two barplot rows: LTA and FOSCTTM per method."""
    import matplotlib.pyplot as plt
    import seaborn as sns
    df, k = integration_scores(data, labels, names, device)
    fig = plt.gcf()
    for row, col in enumerate(['LTA', 'FOSCTTM']):
        ax = fig.add_subplot(2, 1, row + 1)
        sns.barplot(x=df['Algorithm'], y=df[col], ax=ax, palette=colors)
        ax.set_ylabel(f'LTA (k={k})' if col == 'LTA' else col)
        ax.set_xlabel(None)


def plot_accuracy_table(data, labels, names, exclude=(), device=None):
    """Circle-matrix score table: one disc per (metric, method), disc area
    tracking within-metric normalized quality, raw value printed on top."""
    import matplotlib.pyplot as plt
    from matplotlib.collections import PatchCollection
    keep = [i for i in range(len(data)) if i not in exclude]
    df, k = integration_scores([data[i] for i in keep], labels,
                               [names[i] for i in keep], device)
    metrics = [(f'LTA (k={k})', df['LTA'].to_numpy(), +1),
               ('FOSCTTM', df['FOSCTTM'].to_numpy(), -1)]

    ax = plt.gcf().add_subplot(1, 1, 1)
    discs, texts = [], []
    for row, (label, vals, sign) in enumerate(metrics):
        oriented = sign * vals
        lo, hi = oriented.min(), oriented.max()
        quality = (oriented - lo) / (hi - lo) if hi > lo \
            else np.ones_like(oriented)
        for col, (q, raw) in enumerate(zip(quality, vals)):
            discs.append(plt.Circle((col, row), radius=0.2 + 0.3 * q))
            texts.append((col, row, f'{raw:.2f}'))
    ax.add_collection(PatchCollection(discs, facecolor='lightsteelblue'))
    for cx, cy, s in texts:
        ax.text(cx, cy, s, ha='center', va='center', color='black')
    n_methods, n_metrics = len(df), len(metrics)
    ax.set(xticks=range(n_methods), yticks=range(n_metrics),
           xticklabels=df['Algorithm'], yticklabels=[m[0] for m in metrics])
    ax.set_xticks(np.arange(n_methods + 1) - .5, minor=True)
    ax.set_yticks(np.arange(n_metrics + 1) - .5, minor=True)
    ax.grid(which='minor')
    ax.axis('square')
    ax.set_xlim(-.5, n_methods - .5)
    ax.set_ylim(-.5, n_metrics - .5)


def plot_accuracy_graph(data, labels, names, colors=None, shapes=None,
                        device=None, **kwargs):
    """FOSCTTM-vs-LTA scatter (x inverted so up-and-right is better)."""
    import matplotlib.pyplot as plt
    df, k = integration_scores(data, labels, names, device)
    print(df.set_index('Algorithm').T)
    colors = colors if colors is not None else [None] * len(data)
    shapes = shapes if shapes is not None else [None] * len(data)
    ax = plt.gca()
    for i, row in df.iterrows():
        ax.scatter(row['FOSCTTM'], row['LTA'], c=colors[i],
                   marker=shapes[i], s=200.)
        ax.annotate(str(row['Algorithm']).replace('\n', ' '),
                    (row['FOSCTTM'], row['LTA']), ha='center', va='bottom')
    ax.invert_xaxis()
    ax.set_xlabel('FOSCTTM')
    ax.set_ylabel(f'LTA (k={k})')
    return ax


def plot_silhouette(data, labels, names, modal_names, colors=None,
                    device=None):
    """Per-modality silhouette-coefficient boxplots, grouped by cell type
    and hued by method."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    codes = [np.unique(t, return_inverse=True)[1] for t in labels]
    label_values = np.unique(np.concatenate(labels))

    n_modal = len(data[0])
    axes = plt.gcf().subplots(1, n_modal)
    axes = np.atleast_1d(axes)
    for m, ax in enumerate(axes):
        frames = []
        for j, emb in enumerate(data):
            widths = silhouette_samples(emb[m], codes[m], device)
            frames.append(pd.DataFrame({
                'Type': labels[m], 'Silhouette Coefficient': widths,
                'Algorithm': names[j]}))
        long = pd.concat(frames, ignore_index=True)
        sns.boxplot(data=long, x='Type', y='Silhouette Coefficient',
                    hue='Algorithm', ax=ax, palette=colors)
        for sep in range(len(label_values) - 1):
            ax.axvline(x=sep + .5, color='black', linestyle='--')
        ax.set_title(f'Silhouette Coefficients ({modal_names[m]})')
        ax.set_xlabel(None)
        ax.set_ylabel(None)
        ax.get_legend().remove()


# --------------------------------------------------------------------------
# Imputation quality figures
# --------------------------------------------------------------------------
def _imputation_panel(ax, imputed_data, data, modal_names, i, names, kind,
                      max_features, plot_type='scatter'):
    truth = data[i]
    per_method = []
    rng = np.random
    feat_idx = rng.choice(truth.shape[1], min(truth.shape[1], max_features),
                          replace=False)
    for method in imputed_data:
        if kind == 'auroc':
            scores = _binary_auroc_by_column(
                np.asarray(method[i], np.float64)[:, feat_idx],
                np.asarray(truth, np.float64)[:, feat_idx]
                > np.median(truth))
        else:
            scores = _pearson_by_column(
                np.asarray(method[i], np.float64)[:, feat_idx],
                np.asarray(truth, np.float64)[:, feat_idx])
        per_method.append(scores)
    keep = np.all(np.isfinite(np.stack(per_method)), axis=0)
    per_method = [s[keep] for s in per_method]
    title = ('AUROC' if kind == 'auroc' else 'Correlation')
    _paired_scatter(ax, per_method[0], per_method[1],
                    xlabel=names[0], ylabel=names[1],
                    title=f'{title} - {modal_names[i]}',
                    plot_type=plot_type)
    return per_method


def _plot_auroc(imputed_data, data, modal_names, ax, i=0, names=None,
                max_features=100_000, return_statistic=False,
                plot_type='scatter'):
    """Per-feature imputation AUROC, method B vs method A."""
    stat = _imputation_panel(ax, imputed_data, data, modal_names, i, names,
                             'auroc', max_features, plot_type)
    if return_statistic:
        return stat


def _plot_correlation(imputed_data, data, modal_names, ax, i=0, names=None,
                      max_features=100_000, return_statistic=False,
                      plot_type='scatter'):
    """Per-feature imputation Pearson r, method B vs method A."""
    stat = _imputation_panel(ax, imputed_data, data, modal_names, i, names,
                             'pearson', max_features, plot_type)
    if return_statistic:
        return stat


def plot_auroc(*args, **kwargs):
    import matplotlib.pyplot as plt
    axes = plt.gcf().subplots(1, 2)
    for i, ax in enumerate(axes):
        _plot_auroc(*args, ax=ax, i=i, **kwargs)


def plot_correlation(*args, **kwargs):
    import matplotlib.pyplot as plt
    axes = plt.gcf().subplots(1, 2)
    for i, ax in enumerate(axes):
        _plot_correlation(*args, ax=ax, i=i, **kwargs)


def plot_auroc_correlation(*args, index=0, **kwargs):
    import matplotlib.pyplot as plt
    axes = plt.gcf().subplots(1, 2)
    return (_plot_auroc(*args, ax=axes[0], i=index, **kwargs),
            _plot_correlation(*args, ax=axes[1], i=index, **kwargs))


def plot_sample(true, imputed, name, modal_name, suptitle=None,
                sample_idx=None, color='blue', scale=None,
                plot_type='scatter'):
    """Measured-vs-imputed scatter for one cell; picks the best-R^2 cell
    when sample_idx is None. Returns the cell index plotted."""
    import matplotlib.pyplot as plt
    from scipy import stats
    true = np.asarray(true)
    imputed = np.asarray(imputed)

    if sample_idx is None:
        # R^2 per cell, vectorized: 1 - SSE/SST over features
        sse = ((true - imputed) ** 2).sum(axis=1)
        sst = ((true - true.mean(axis=1, keepdims=True)) ** 2).sum(axis=1)
        with np.errstate(divide='ignore', invalid='ignore'):
            r2_all = 1.0 - sse / sst
        sample_idx = int(np.nanargmax(r2_all))
        r2 = float(r2_all[sample_idx])
    else:
        sse = ((true[sample_idx] - imputed[sample_idx]) ** 2).sum()
        sst = ((true[sample_idx] - true[sample_idx].mean()) ** 2).sum()
        r2 = float(1.0 - sse / sst) if sst > 0 else np.nan
    p_value = stats.pearsonr(true[sample_idx], imputed[sample_idx])[1]

    ax = plt.gca()
    ax.scatter(true[sample_idx], imputed[sample_idx], facecolor=color,
               edgecolor='none', s=5 if true.shape[1] > 100 else 15)
    ax.axis('square')
    ax.set_title(f'{suptitle or "Cell"} - {modal_name}')
    ax.set_xlabel('Measured')
    ax.set_ylabel(name)
    lo = min(ax.get_xlim()[0], ax.get_ylim()[0])
    hi = max(ax.get_xlim()[1], ax.get_ylim()[1])
    ax.set_xlim((lo, hi))
    ax.set_ylim((lo, hi))
    if scale is not None:
        ax.set_xscale(scale)
        ax.set_yscale(scale)
    ax.plot([lo, hi], [lo, hi], '--', color='black', alpha=0.75, zorder=-1)
    note = dict(ha='left', va='center', transform=ax.transAxes,
                backgroundcolor='white')
    ax.text(.05, .9, f'p-value: {p_value:.2E}', **note)
    ax.text(.05, .8, f'$R^2$: {r2:.2E}', **note)
    return sample_idx


# --------------------------------------------------------------------------
# Feature-distribution figures
# --------------------------------------------------------------------------
def _feature_longform(matrix, labels, fname_row):
    """(N, Fsel) matrix -> long-form rows for seaborn boxplots."""
    import pandas as pd
    n, f = matrix.shape
    return pd.DataFrame({
        'Variable': np.repeat(fname_row, n),
        'Value': matrix.T.reshape(-1),
        'Type': np.tile(np.asarray(labels), f),
    })


def plot_distribution_alone(datasets, labels, label_order=None,
                            feature_limit=2, title=None, fnames=None,
                            gcf=None, rows=2, remove_outliers=True,
                            equal_axes=False, sort_type='entropy-corr',
                            feature_dict=None, **kwargs):
    """Measured-vs-imputed per-cell-type boxplots for the most interesting
    features (ranked by sort_by_interest); prints each feature's JS score."""
    import matplotlib.pyplot as plt
    import seaborn as sns
    from .utils import jensen_shannon_from_array, outliers, set_yticks, \
        sort_by_interest
    feature_dict = feature_dict or {}
    datasets = [np.asarray(d) for d in datasets]
    if fnames is None:
        fnames = [None, None]
    fnames = [np.asarray(fn) if fn is not None
              else np.array([f'Feature {j}'
                             for j in range(datasets[i].shape[1])])
              for i, fn in enumerate(fnames)]
    gcf = gcf or plt.gcf()
    feature_limit = (feature_limit if feature_limit is not None
                     else datasets[0].shape[1])

    chosen = sort_by_interest(datasets, limit=feature_limit,
                              remove_outliers=remove_outliers,
                              sort_type=sort_type)[1]
    datasets = [d[:, chosen] for d in datasets]
    fnames = [np.array([feature_dict.get(nm, nm) for nm in fn[chosen]])
              for fn in fnames]

    for j in range(datasets[0].shape[1]):
        js = jensen_shannon_from_array([d[:, j] for d in datasets])
        print(f'{fnames[0][j]}: {js}')

    order = label_order if label_order is not None else np.unique(labels)
    rank = {lab: r for r, lab in enumerate(np.asarray(order))}
    row_names = ['Measured', 'Imputed']
    axes = []
    prev = None
    for i in range(2):
        ax = gcf.add_subplot(rows, 1, rows - 1 + i, sharex=prev)
        prev = ax
        axes.append(ax)
        long = _feature_longform(datasets[i], labels[i], fnames[i])
        long = long.iloc[np.argsort([rank[t] for t in long['Type']],
                                    kind='stable')]
        sns.boxplot(data=long, x='Variable', y='Value', hue='Type', ax=ax)
        for sep in range(feature_limit - 1):
            ax.axvline(x=sep + .5, color='black', linestyle='--')
        ax.set_xlabel(None)
        ax.set_ylabel(row_names[i])
        ax.legend([], [], frameon=False)
        if i == 0:
            ax.set_xticks([])
            ax.set_xticklabels([])
            ax.set_title(f'Sample Feature Distributions ({title})')

    if remove_outliers:
        for ax, d in zip(axes, datasets):
            _, (lo, hi, span) = outliers(d, return_limits=True)
            want = (np.min(lo - 1.5 * span), np.max(hi + 1.5 * span))
            ax.set_ylim((max(want[0], ax.get_ylim()[0]),
                         min(want[1], ax.get_ylim()[1])))
    if equal_axes:
        shared = (min(ax.get_ylim()[0] for ax in axes),
                  max(ax.get_ylim()[1] for ax in axes))
        for ax in axes:
            ax.set_ylim(shared)
    for ax in axes:
        set_yticks(ax, 4)
    plt.gcf().subplots_adjust(hspace=0)


def plot_distribution(datasets, labels, feature_limit=3, title=None,
                      **kwargs):
    """Similarity curve strip on top of the distribution boxplots."""
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt
    from .utils import set_yticks
    datasets = [np.asarray(d) for d in datasets]
    top = plt.gcf().add_subplot(3, 1, 1)
    top.set_subplotspec(gridspec.GridSpec(3, 1, height_ratios=[1, 2, 2])[0])
    plot_distribution_similarity(datasets, labels, suptitle=title, ax=top,
                                 square=False, legend=False, **kwargs)
    set_yticks(top, 2)
    top.set_xticks([])
    top.set_xlim([0, 1])
    top.set_ylabel('Simulated')
    plot_distribution_alone(datasets, labels, rows=3, title=None,
                            feature_limit=feature_limit, **kwargs)
    plt.gcf().subplots_adjust(hspace=0)


def plot_distribution_similarity(datasets, labels, label_order=None,
                                 suptitle=None, title=None, max_features=100,
                                 relative=True, label_cells=True, legend=True,
                                 square=True, ax=None, **kwargs):
    """Sorted per-feature JS-similarity curves, one per cell type, plus the
    across-type mean as a thick black 'Cumulative' curve. Prints the overall
    mean distance and std."""
    import matplotlib.pyplot as plt
    from .utils import jensen_shannon_from_array
    assert datasets[0].shape[1] == datasets[1].shape[1]
    datasets = [np.asarray(d) for d in datasets]
    n_feat = min(datasets[0].shape[1], max_features)
    feat_idx = np.random.choice(datasets[0].shape[1], n_feat, replace=False)
    ax = ax or plt.gcf().add_subplot(1, 1, 1)

    type_values = (np.unique(labels) if label_order is None else label_order)
    similarity = {}
    for lab in type_values:
        per_feature = []
        for f in feat_idx:
            try:
                js = jensen_shannon_from_array(
                    [d[labels[i] == lab, f] for i, d in enumerate(datasets)])
                js = 1.0 if np.isnan(js) else js
            except Exception:
                js = 0.0
            per_feature.append(1.0 - js)
        similarity[lab] = np.asarray(per_feature)

    pooled = np.concatenate(list(similarity.values()))
    print(f'Mean: {1 - np.mean(pooled)}')
    print(f'Std: {np.std(pooled)}')

    pct = np.linspace(0, 1, n_feat)
    for lab, vals in similarity.items():
        ax.plot(pct, np.sort(vals),
                label=lab if label_cells else '_nolegend_')
    mean_curve = np.mean(np.stack(list(similarity.values())), axis=0)
    ax.plot(pct, np.sort(mean_curve), label='Cumulative', linewidth=6,
            color='black')
    ax.set_xlabel('Percentile')
    ax.set_ylabel(f'{title} Similarity')
    ax.set_xlim([0, 1])
    ax.set_ylim([0, 1])
    ax.set_title(suptitle)
    if square:
        ax.set_aspect('equal', adjustable='box')
    ax.legend() if legend else ax.legend([], [], frameon=False)


# --------------------------------------------------------------------------
# Feature-importance bars
# --------------------------------------------------------------------------
def plot_impact(values, fnames, baseline, ylabel='LTA', max_features=None,
                background_pct=.3, sort='mixed-min', color=None,
                max_name_len=10, seed=42):
    """Occlusion-importance bars with the unoccluded baseline as a red line.

    'mixed-*' sorts keep the top (1-background_pct) fraction by impact and
    fill the rest with random background features, then shuffle — the figure
    shows standouts against typical features rather than a sorted ramp.
    """
    import matplotlib.pyplot as plt
    import seaborn as sns
    if seed is not None:
        np.random.seed(seed)
    values = np.asarray(values)
    fnames = np.asarray(fnames)
    n_show = min(len(values), max_features or len(values))

    if sort is not None:
        parts = sort.split('-')
        ascending = np.argsort(values)
        if parts[0] == 'min':
            pick = ascending
        elif parts[0] == 'max':
            pick = ascending[::-1]
        elif parts[0] == 'mixed' and parts[-1] in ('min', 'max'):
            ranked = ascending if parts[-1] == 'min' else ascending[::-1]
            top = ranked[:int((1 - background_pct) * n_show)]
            rest = np.setdiff1d(np.arange(len(values)), top)
            fill = np.random.choice(rest, n_show - len(top), replace=False)
            pick = np.concatenate([top, fill]).astype(int)
            np.random.shuffle(pick)
        else:
            raise AssertionError(f"Invalid sort method '{sort}' provided.")
        values = values[pick]
        fnames = fnames[pick]
    values = values[:n_show]
    shown_names = [str(f)[:max_name_len] for f in fnames[:n_show]]

    ax = plt.gcf().add_subplot(1, 1, 1)
    sns.barplot(x=shown_names, y=values, ax=ax, color=color)
    plt.setp(ax.patches, linewidth=0)
    ax.axhline(y=baseline, color='red', linewidth=3, zorder=-1)
    ax.set_ylabel(ylabel)
    spread = values.max() - values.min()
    ax.set_ylim([max(values.min() - spread, -1 if values.min() < 0 else 0),
                 min(values.max() + spread, 1)])
    if values.min() < 0:
        plt.axhline(y=0, color='black')
    plt.xticks(rotation=80)


def plot_shap_summary(phi, data, feature_names=None, max_features=15,
                      output_index=None, ax=None, seed=0):
    """Beeswarm-style SHAP summary (the native stand-in for the reference
    notebooks' shap.summary_plot, scMNC-Visual.ipynb explanation cells):
    one row per feature (top `max_features` by mean |phi|), horizontal
    jittered scatter of per-sample attributions, colored by the feature's
    (min-max normalized) value.

    phi: (n, F, D) attributions from `evaluation.kernel_shap` (or (n, F));
    data: (n, F) raw inputs the attributions were computed on;
    output_index: which output column to show (default: mean over outputs).
    """
    import matplotlib.pyplot as plt
    if hasattr(phi, 'values'):        # ShapValues / shap Explanation
        phi = phi.values
    phi = np.asarray(phi)
    if phi.ndim == 3:
        phi = (phi.mean(axis=2) if output_index is None
               else phi[:, :, output_index])
    data = np.asarray(data)
    names = (np.asarray(feature_names) if feature_names is not None
             else np.array([f'f{j}' for j in range(phi.shape[1])]))
    order = np.argsort(np.abs(phi).mean(axis=0))[::-1][:max_features]
    rng = np.random.RandomState(seed)
    if ax is None:
        ax = plt.gcf().add_subplot(1, 1, 1)
    for row, j in enumerate(order[::-1]):
        v = data[:, j].astype(np.float64)   # int inputs: keep 0.5 exact
        lo, hi = v.min(), v.max()
        c = (v - lo) / (hi - lo) if hi > lo else np.full(v.shape, 0.5)
        ax.scatter(phi[:, j], row + 0.12 * rng.randn(phi.shape[0]),
                   c=c, cmap='coolwarm', s=14, linewidths=0, alpha=0.8)
    ax.axvline(0, color='gray', linewidth=1)
    ax.set_yticks(range(len(order)))
    ax.set_yticklabels([str(names[j]) for j in order[::-1]])
    ax.set_xlabel('SHAP value (impact on model output)')
    return ax


def plot_shap_waterfall(phi_row, base, feature_names=None, max_features=10,
                        output_index=0, ax=None):
    """Waterfall for ONE explained sample (stand-in for
    shap.plots.waterfall): the largest-|phi| features step from the base
    value to the model output, remaining features collapsed into one bar.

    phi_row: (F,) or (F, D) attributions for one sample;
    base: scalar (or (D,)) baseline model output for that sample.
    """
    import matplotlib.pyplot as plt
    phi_row = np.asarray(phi_row)
    if phi_row.ndim == 2:
        phi_row = phi_row[:, output_index]
    base = np.asarray(base).reshape(-1)
    base = float(base[output_index] if base.size > 1 else base[0])
    names = (np.asarray(feature_names) if feature_names is not None
             else np.array([f'f{j}' for j in range(phi_row.shape[0])]))
    order = np.argsort(np.abs(phi_row))[::-1]
    head, rest = order[:max_features], order[max_features:]
    vals = list(phi_row[head])
    labels = [str(names[j]) for j in head]
    if rest.size:
        vals.append(float(phi_row[rest].sum()))
        labels.append(f'{rest.size} other features')
    if ax is None:
        ax = plt.gcf().add_subplot(1, 1, 1)
    cum = base
    for row, (v, lab) in enumerate(zip(vals, labels)):
        ax.barh(len(vals) - 1 - row, v, left=cum,
                color='#d62728' if v >= 0 else '#1f77b4', height=0.7)
        cum += v
    ax.axvline(base, color='gray', linewidth=1, linestyle='--')
    ax.set_yticks(range(len(vals)))
    ax.set_yticklabels(labels[::-1])
    ax.set_xlabel(f'model output (base {base:.3f} -> {cum:.3f})')
    return ax
