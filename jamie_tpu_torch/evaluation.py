"""Evaluation metrics and explanations.

Reference parity: `jamie_tpu/evaluation.py` (jamie/evaluation.py
`test_partial` :28-62, `test_closer` :65-85, `test_label_dist` :88-111,
`test_LabelTA` :114-132, `evaluate_impact` :965-1043). FOSCTTM, the kNN
label transfer and the centroid distances take their distances from the K3
kernel (`ops/pairwise.py`) on `device`, in row blocks of
max(_FOSCTTM_BLOCK_ENTRIES // n, 256) rows (one block up to
`_FOSCTTM_BLOCK_ENTRIES` entries), exact at any N.

Explanations: `evaluate_impact` (host occlusion around any function),
`occlusion_impact_device` (each batch of occluded copies in one eval-mode
forward on the estimator's device), the native `kernel_shap` (host
coalitions from `np.random.RandomState(seed)`, as in jamie_tpu; one float32
least-squares solve on the device) and `shap_explain`, which uses the
`shap` package where it is installed. The figures are in `figures.py`
(re-exported here, as in jamie_tpu);
`test_partial(plot=True)` imports matplotlib itself.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .core.dtypes import resolve_device
from .ops.distances import _as_device_f32
from .ops.pairwise import pairwise_euclidean

# Each row block of these metrics' distances holds about this many entries
# (1 GB of f32; jamie_tpu/evaluation.py:67). A block size, not a route:
# kept, as the `residency` probe timed FOSCTTM at 100,000 cells alike with
# 2^26, 2^28 and 2^30-entry blocks (H100 80GB HBM3, 700.00 W).
_FOSCTTM_BLOCK_ENTRIES = 1 << 28


__all__ = [
    'test_partial', 'test_closer', 'test_label_dist', 'test_LabelTA',
    'knn_label_transfer_accuracy', 'evaluate_impact',
    'occlusion_impact_device', 'shap_explain', 'kernel_shap', 'ShapValues',
    'plot_regular', 'plot_integrated', 'plot_accuracy',
    'plot_accuracy_table', 'plot_accuracy_graph', 'plot_silhouette',
    'plot_auroc', 'plot_correlation', 'plot_auroc_correlation',
    'plot_sample', 'plot_distribution', 'plot_distribution_alone',
    'plot_distribution_similarity', 'plot_impact',
    'plot_shap_summary', 'plot_shap_waterfall',
]


def _block_rows(n_cols: int) -> int:
    return max(_FOSCTTM_BLOCK_ENTRIES // n_cols, 256)


def _foscttm_block(a_blk, b, diag_blk, diag, start: int) -> torch.Tensor:
    """One row block's count for both FOSCTTM directions (int64): the
    (bs, n) distance block against the block's own true-match distances
    (a->b) and every column's (b->a). The block's self-pair entries are
    overwritten with the exact diagonal, so K3's rounding there never flips
    the strict < (a self-pair counts in neither direction)."""
    d = pairwise_euclidean(a_blk, b, squared=True)
    rows = torch.arange(a_blk.shape[0], device=d.device)
    d[rows, start + rows] = diag_blk
    return (torch.sum(d < diag_blk[:, None])
            + torch.sum(d < diag[None, :]))


def test_closer(integrated_data, distance_metric=None, device=None) -> float:
    """FOSCTTM, both directions (evaluation.py:65-85)."""
    assert len(integrated_data) == 2, 'Two datasets are supported for FOSCTTM'
    if distance_metric is not None:
        distances = distance_metric(np.concatenate(integrated_data, axis=0))
        size = integrated_data[0].shape[0]
        raw = 0
        for i in range(size):
            local = distances[i][size:]
            raw += np.sum(local < local[i])
            local = distances[size + i][:size]
            raw += np.sum(local < local[i])
        foscttm = raw / (2 * size ** 2)
    else:
        device = resolve_device(device)
        a = _as_device_f32(integrated_data[0], device)
        b = _as_device_f32(integrated_data[1], device)
        n = a.shape[0]
        bs = _block_rows(n)
        diag = torch.sum((a - b) ** 2, dim=1)
        closer = sum(_foscttm_block(a[s:s + bs], b, diag[s:s + bs], diag, s)
                     for s in range(0, n, bs))
        foscttm = int(closer) / (2.0 * n * n)
    print(f'foscttm: {foscttm}')
    return foscttm


def test_label_dist(integrated_data, datatype, distance_metric=None,
                    verbose=True, device=None):
    """Average inter-label centroid distances (evaluation.py:88-111)."""
    assert len(integrated_data) == 2, (
        'Two datasets are supported for ``label_dist``')
    data = np.concatenate(integrated_data, axis=0)
    labels = np.concatenate(datatype)
    keys = np.unique(labels)
    centroids = np.stack(
        [np.average(data[labels == lab, :], axis=0) for lab in keys])
    if distance_metric is None:
        dist = pairwise_euclidean(
            _as_device_f32(centroids, resolve_device(device)),
            squared=False).cpu().numpy()
    else:
        dist = distance_metric(centroids)
    if verbose:
        print(f'Inter-label distances ({list(keys)}):')
        print(dist)
    return keys, dist


def knn_label_transfer_accuracy(integrated_data, datatype,
                                k: Optional[int] = None, device=None):
    """kNN classifier transferring labels modality 1 -> 0: sklearn
    KNeighborsClassifier majority vote with the reference's auto-k rule
    (20% of the average class size, jamie.py:946-949)."""
    if k is None:
        total_size = min(*[len(d) for d in datatype])
        num_classes = len(np.unique(np.concatenate(datatype)).flatten())
        k = int(0.2 * total_size / num_classes)
    k = max(int(k), 1)
    device = resolve_device(device)
    fit_x = _as_device_f32(integrated_data[1], device)
    query = _as_device_f32(integrated_data[0], device)
    uniq, fit_labels = np.unique(np.asarray(datatype[1]), return_inverse=True)
    k = min(k, fit_x.shape[0])
    fit_labels = torch.as_tensor(fit_labels, device=device)

    def block_pred(q_blk):
        d = pairwise_euclidean(q_blk, fit_x, squared=True)
        nn_idx = torch.topk(d, k, dim=1, largest=False).indices
        votes = fit_labels[nn_idx]                              # (bq, k)
        counts = torch.nn.functional.one_hot(votes, len(uniq)).sum(1)
        return torch.argmax(counts, dim=1)

    # kNN is per query row: row blocks are exact at any N
    bs = _block_rows(fit_x.shape[0])
    pred = torch.cat([block_pred(query[s:s + bs])
                      for s in range(0, query.shape[0], bs)])
    acc = float(np.mean(uniq[pred.cpu().numpy()] == np.asarray(datatype[0])))
    return acc, k


def test_LabelTA(integrated_data, datatype, k=5, return_k=False,
                 device=None):
    """Label-transfer accuracy (evaluation.py:114-132; default k=5)."""
    acc, k = knn_label_transfer_accuracy(integrated_data, datatype, k=k,
                                         device=device)
    print(f'label transfer accuracy: {acc}')
    if return_k:
        return acc, k
    return acc


def test_partial(datasets, types, fraction_range=None, plot=True, **kwargs):
    """Partial-alignment sweep (evaluation.py:28-62): refit with diagonal
    priors masked to each fraction of the cells (`np.random.choice`, as
    jamie_tpu draws them), tracking LTA and FOSCTTM. kwargs go to JAMIE
    (device= included)."""
    from .estimator import JAMIE
    if fraction_range is None:
        fraction_range = np.linspace(0, 1, 3)
    assert len(datasets[0]) == len(datasets[1]), 'Datasets must be aligned.'

    types = [np.unique(t, return_inverse=True)[1] for t in types]
    num_samples = len(datasets[0])
    acc_list = {'lta': [], 'foscttm': []}
    for fraction in fraction_range:
        random_idx = np.random.choice(
            range(num_samples), int(fraction * num_samples), replace=False)
        random_diag = np.zeros(num_samples)
        random_diag[random_idx] = 1
        cm = JAMIE(P=np.diag(random_diag), **kwargs)
        with contextlib.redirect_stdout(None):
            cm_data = cm.fit_transform(dataset=datasets)
            acc_list['lta'].append(cm.test_LabelTA(cm_data, types))
            acc_list['foscttm'].append(cm.test_closer(cm_data))

    if plot:
        import matplotlib.pyplot as plt
        for key, v in acc_list.items():
            plt.plot(fraction_range, v, '.-', label=key)
        plt.xlabel('Fraction Assumed Aligned')
        plt.ylabel('Statistic')
        plt.legend()
    return acc_list, fraction_range


# --------------------------------------------------------------------------
# Occlusion-based feature importance
# --------------------------------------------------------------------------
def evaluate_impact(function, perf_function, in_data, true, features=None,
                    idx=None, mode='replace', sequential=False, scan=None,
                    scan_samples=500, seed=42):
    """Occlusion importance with the reference API (evaluation.py:965-1043).

    mode='replace' occludes one feature at a time with the background
    (column mean); mode='keep' occludes everything BUT the feature.
    sequential=True accumulates occlusions across features instead of
    restoring between evaluations. `scan` first ranks all candidates on a
    row subsample (passing idx= to `function`) and then evaluates only the
    top `scan` in full. Returns (baseline_performance, per-feature
    performance, testing_idx).
    """
    assert mode in ['replace', 'keep']
    if seed is not None:
        np.random.seed(seed)
    data = np.array(in_data)
    testing_idx = np.asarray(idx) if idx is not None \
        else np.arange(data.shape[1])
    background = data.mean(axis=0)
    baseline = perf_function(function(data), true)

    if scan is not None:
        print('Performing preliminary scan...')
        rows = np.random.choice(data.shape[0],
                                min(scan_samples, data.shape[0]),
                                replace=False)
        quick = _occlusion_pass(
            lambda x: function(x, idx=rows), perf_function, data[rows],
            None if true is None else true[rows], background,
            testing_idx, mode, sequential)
        # keep the features whose occlusion hurts most: low performance in
        # 'replace', high in 'keep'
        order = np.argsort(quick if mode == 'replace' else -quick)
        testing_idx = testing_idx[order[:scan]]
    print('Finding important features...')
    performance = _occlusion_pass(function, perf_function, data, true,
                                  background, testing_idx, mode, sequential)
    print('Done!')
    return baseline, performance, testing_idx


def _occlusion_pass(function, perf_function, data, true, background,
                    testing_idx, mode, sequential, log_every=10):
    """One occlusion sweep over `testing_idx`; never mutates the caller's
    array."""
    work = data.copy()
    all_cols = np.arange(work.shape[1])
    scores = np.empty(len(testing_idx))
    for i, feat in enumerate(testing_idx):
        cols = np.array([feat]) if mode == 'replace' \
            else all_cols[all_cols != feat]
        saved = work[:, cols].copy()
        work[:, cols] = background[cols]
        p = perf_function(function(work), true)
        scores[i] = np.inf if np.isnan(p) else p
        # keep mode always restores: the reference's boolean-mask indexing
        # copies, so its "sequential" occlusion only ever accumulates in
        # replace mode (evaluation.py:1022-1036)
        if not sequential or mode == 'keep':
            work[:, cols] = saved
        if (i + 1) % log_every == 0 or i + 1 == len(testing_idx):
            frac = (i + 1) / len(testing_idx)
            print(f'occlusion {i + 1}/{len(testing_idx)} '
                  f'({100 * frac:.0f}%)', end='\r')
    print()
    return scores


@torch.no_grad()
def occlusion_impact_device(estimator, in_data, true, modality: int = 0,
                            batch_features: int = 32, idx=None,
                            space: str = 'input'):
    """Occlusion importance for imputation on the estimator's device
    (jamie_tpu/evaluation.py:278-374): each batch of `batch_features`
    occluded copies of the input goes through ONE eval-mode forward as a
    (batch_features * N, dim) matrix (eval-mode BatchNorm uses its running
    stats, so rows do not interact), in place of jamie_tpu's vmap over the
    features. Returns (baseline_r, per-feature impact = baseline -
    occluded_r, testing_idx); r is the mean per-output-column Pearson
    correlation with `true`, the opposite modality's ground truth in the
    preprocessed space.

    space='input' (default) occludes RAW input features (each replaced by
    its column mean), so testing_idx aligns with gene/peak names. With a
    PCA preclass the occluded activations are exact by linearity:
    replacing raw column j with its mean b_j shifts the standardized
    scores by (b_j - X[:, j]) / sigma times component row j. A nonlinear
    preclass (tsne/umap) has no such shortcut and raises; use
    `evaluate_impact` or space='latent', which occludes columns of the
    PREPROCESSED matrix (PCA components when pca_dim is set).
    """
    from .preprocess import NonlinearEmbedding

    assert space in ('input', 'latent')
    to_mod = (modality + 1) % 2
    pre_in = estimator.preprocessors[modality]
    pre_out = estimator.preprocessors[to_mod]
    model = estimator.model
    model.eval()
    dev = estimator.device
    raw = np.asarray(in_data, np.float32)
    x = torch.as_tensor(pre_in.transform(raw), device=dev)
    true_t = torch.as_tensor(pre_out.transform(np.asarray(true)), device=dev)
    tc = true_t - true_t.mean(0)
    tc_norm = torch.linalg.vector_norm(tc, dim=0)
    n = x.shape[0]

    def mean_r(xb):
        """(B, N, dim) inputs -> (B,) mean correlation of the imputation."""
        b = xb.shape[0]
        pred = model.impute(xb.reshape(b * n, -1), modality, to_mod)
        pred = pred.float().reshape(b, n, -1)
        pc = pred - pred.mean(1, keepdim=True)
        num = (pc * tc).sum(1)
        den = torch.linalg.vector_norm(pc, dim=1) * tc_norm
        return (num / torch.clamp(den, min=1e-12)).mean(1)

    baseline = float(mean_r(x[None])[0])

    if space == 'latent' or pre_in.pca is None:
        # A no-PCA preclass is per-feature standardization, so occluding
        # the transformed column IS occluding the raw feature.
        if space == 'input' and pre_in.pca is None:
            tb = torch.as_tensor(
                pre_in.transform(raw.mean(axis=0, keepdims=True))[0],
                device=dev)
        else:
            tb = x.mean(0)
        n_feat = x.shape[1]

        def occluded(fids):
            xo = x[None].repeat(len(fids), 1, 1)
            rows = torch.arange(len(fids), device=dev)
            xo[rows, :, fids] = tb[fids][:, None]
            return xo
    elif isinstance(pre_in.pca, NonlinearEmbedding):
        raise ValueError(
            "space='input' needs a linear (PCA) preclass; this estimator "
            "used model_pca='tsne'/'umap'. Use evaluate_impact (host, "
            "exact) or space='latent'.")
    else:
        comps = pre_in.pca.components_                       # (dim, F)
        sigma = max(float(pre_in.sample_std), 1e-12)
        raw_dev = torch.as_tensor(raw, device=dev)
        b_mean = raw_dev.mean(0)
        n_feat = raw.shape[1]

        def occluded(fids):
            delta = (b_mean[fids] - raw_dev[:, fids]) / sigma   # (N, B)
            return x[None] + delta.T[:, :, None] * comps[:, fids].T[:, None]

    testing_idx = np.asarray(idx if idx is not None else np.arange(n_feat))
    ids = torch.as_tensor(testing_idx, dtype=torch.long, device=dev)
    occluded_r = torch.cat([
        mean_r(occluded(ids[s:s + batch_features]))
        for s in range(0, len(testing_idx), batch_features)])
    return baseline, baseline - occluded_r.cpu().numpy(), testing_idx


def _shapley_kernel_sizes(n_feat: int, n_coalitions: int, rng):
    """Draw coalition sizes k in [1, n_feat-1] from the Shapley kernel
    distribution p(k) proportional to (n_feat - 1) / (k (n_feat - k)), the
    size marginal of Lundberg & Lee's pi(z). The empty and full coalitions
    carry infinite weight and are handled exactly by the
    efficiency-constraint substitution, not sampled."""
    k = np.arange(1, n_feat)
    p = (n_feat - 1) / (k * (n_feat - k))
    p /= p.sum()
    return rng.choice(k, size=n_coalitions, p=p)


def _kernel_shap_solve(Z, w, Y, total):
    """Weighted least squares with the efficiency constraint eliminated
    (float32 tensors on one device).

    Z: (S, F) 0/1 coalition matrix, w: (S,) Shapley kernel weights,
    Y: (S, B) centered model outputs f(masked) - f(background) for B
    explained (sample, output) columns, total: (B,) f(x) - f(background).
    Substituting phi_F = total - sum_{j<F} phi_j turns the constrained
    regression into an unconstrained one over the first F-1 features; ONE
    (F-1, F-1) solve serves every column because the coalition design is
    shared. Returns (F, B)."""
    A = Z[:, :-1] - Z[:, -1:]                      # (S, F-1)
    y = Y - Z[:, -1:] * total[None, :]             # (S, B)
    Aw = A * w[:, None]
    G = A.T @ Aw                                   # (F-1, F-1)
    G = G + 1e-8 * torch.trace(G) / A.shape[1] * torch.eye(
        A.shape[1], dtype=G.dtype, device=G.device)
    phi_head = torch.linalg.solve(G, Aw.T @ y)     # (F-1, B)
    phi_last = total[None, :] - torch.sum(phi_head, dim=0, keepdim=True)
    return torch.cat([phi_head, phi_last], dim=0)


def kernel_shap(predict_fn, data, explain=None, background=None,
                n_coalitions: int = 512, features=None, seed: int = 0,
                batch_rows: int = 65536, device=None):
    """Native KernelSHAP (Lundberg & Lee 2017) for a batched black-box
    `predict_fn` (jamie_tpu/evaluation.py:410-522), the replacement for the
    reference notebooks' `shap.Explainer(lambda x: model.modal_predict(x,
    m), data)` with no external dependency.

    One coalition design (S, F) from `np.random.RandomState(seed)` is shared
    by every explained row, so the job is one batched model evaluation over
    all masked inputs (built and evaluated `batch_rows` at a time), then ONE
    (F-1, F-1) weighted least-squares solve in float32 on `device` whose
    right-hand side stacks every (explained row, output) column. The
    empty/full coalitions are not sampled: the efficiency constraint
    sum(phi) = f(x) - f(background) is enforced exactly by substitution.
    For a linear model this recovers (x - background) * W exactly.

    predict_fn: maps (n, F_in) raw inputs to (n, D) (or (n,)) outputs.
    data: (N, F_in) raw inputs; also the default background source.
    explain: row indices to explain (default: all rows).
    background: (F_in,) reference vector; default data.mean(axis=0).
    features: optional indices OR boolean mask: attribute only these,
        holding the rest at their true values (the efficiency total becomes
        f(x) - f(x with the subset backgrounded)).
    Returns (phi, base): phi (n_explained, F_sel, D) attributions, base
    (n_explained, D) = f(x with the selected features backgrounded).
    """
    data = np.asarray(data, np.float32)
    n, f_in = data.shape
    idx = np.arange(n) if explain is None else np.asarray(explain)
    bg = (data.mean(axis=0) if background is None
          else np.asarray(background, np.float32))
    if features is None:
        sel = np.arange(f_in)
    else:
        features = np.asarray(features)
        sel = (np.flatnonzero(features) if features.dtype == np.bool_
               else features.astype(np.int64))
    f_sel = sel.shape[0]
    assert f_sel >= 2, 'kernel_shap needs at least 2 features in play'
    S = int(n_coalitions)
    if S < f_sel + 2:
        # F-1 regression unknowns: fewer rows than that is rank-deficient
        # and the ridge would return an arbitrary solution that still sums
        # to the right total. (shap errors at the same place.)
        raise ValueError(
            f'n_coalitions={S} cannot identify {f_sel} features; need at '
            f'least f_sel+2={f_sel + 2} (2*f_sel+2 recommended). Pass more '
            f'coalitions or scope the game with features=.')
    rng = np.random.RandomState(seed)

    sizes = _shapley_kernel_sizes(f_sel, S, rng)
    Z = np.zeros((S, f_sel), np.float32)
    for s in range(S):
        Z[s, rng.choice(f_sel, size=sizes[s], replace=False)] = 1.0
    k = Z.sum(axis=1)
    w = ((f_sel - 1) / (k * (f_sel - k))).astype(np.float32)

    x = data[idx]                                   # (E, F_in)
    E = x.shape[0]
    x_sel = x[:, sel]                               # (E, F_sel)

    # x with the whole subset backgrounded (the phi baseline) and x itself
    x_base = x.copy()
    x_base[:, sel] = bg[sel]
    ends = np.concatenate([x, x_base], axis=0)

    def _out2d(o, nrows):
        """Scalar-output models returning (n,) become one output column."""
        o = np.asarray(o)
        if o.ndim == 1:
            assert o.shape[0] == nrows, (
                f'predict_fn returned {o.shape} for {nrows} input rows')
            return o[:, None]
        return o

    def _eval(m):
        outs = [_out2d(predict_fn(m[s:s + batch_rows]),
                       min(batch_rows, m.shape[0] - s))
                for s in range(0, m.shape[0], batch_rows)]
        return np.concatenate(outs, axis=0)

    def _eval_masked():
        """Masked inputs for every (explained row, coalition) pair, one
        batch_rows slab at a time (the full (E*S, F_in) matrix can be far
        larger than host memory)."""
        outs = []
        for start in range(0, E * S, batch_rows):
            r = np.arange(start, min(start + batch_rows, E * S))
            i, c = r // S, r % S                    # explained row, coalition
            slab = x[i]                             # copy via fancy index
            slab[:, sel] = (Z[c] * x_sel[i]
                            + (1.0 - Z[c]) * bg[sel][None, :])
            outs.append(_out2d(predict_fn(slab), len(r)))
        return np.concatenate(outs, axis=0)

    y_ends = _eval(ends)
    d_out = y_ends.shape[1]
    fx, f_base = y_ends[:E], y_ends[E:]             # (E, D) each
    y = _eval_masked().reshape(E, S, d_out)

    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    Y = f32((y - f_base[:, None, :]).transpose(1, 0, 2).reshape(S, E * d_out))
    total = f32((fx - f_base).reshape(E * d_out))
    phi = _kernel_shap_solve(f32(Z), f32(w), Y, total).cpu().numpy()
    phi = phi.reshape(f_sel, E, d_out).transpose(1, 0, 2)
    return phi, f_base


class ShapValues:
    """kernel_shap result in the shape downstream code expects from a shap
    Explanation: `.values` (n, F, D) attributions, `.base_values` (n, D)
    baseline outputs, `.data` the explained inputs; indexing returns the
    per-row triple."""

    def __init__(self, values, base_values, data):
        self.values, self.base_values, self.data = values, base_values, data

    def __getitem__(self, i):
        return ShapValues(self.values[i], self.base_values[i], self.data[i])

    def __len__(self):
        return len(self.values)


def shap_explain(estimator, data, modality: int = 0, max_evals=500,
                 **kwargs):
    """SHAP explanation through modal_predict, as the reference notebooks do
    (scMNC-Visual.ipynb cells 35-42). With the `shap` package installed it
    runs shap.Explainer; without it, the native `kernel_shap` (the same
    estimand, its solve on the estimator's device), returned as a
    `ShapValues` with the Explanation-style attributes."""
    try:
        import shap
    except ImportError:
        phi, base = kernel_shap(
            lambda x: estimator.modal_predict(x, modality), data,
            n_coalitions=max_evals, device=estimator.device, **kwargs)
        return ShapValues(phi, base, np.asarray(data))
    explainer = shap.Explainer(
        lambda x: estimator.modal_predict(x, modality), data, **kwargs)
    return explainer(data, max_evals=max_evals)


# The figures live in figures.py (which imports matplotlib inside each
# function) and are re-exported here, as jamie_tpu's evaluation does. At the
# end of the module: figures imports this module's metrics.
from .figures import (  # noqa: E402,F401
    plot_accuracy, plot_accuracy_graph, plot_accuracy_table, plot_auroc,
    plot_auroc_correlation, plot_correlation, plot_distribution,
    plot_distribution_alone, plot_distribution_similarity, plot_impact,
    plot_shap_summary, plot_shap_waterfall,
    plot_integrated, plot_regular, plot_sample, plot_silhouette,
)
