"""Evaluation metrics.

Reference parity: `jamie_tpu/evaluation.py:41-170` (jamie/evaluation.py
`test_closer` :65-85, `test_label_dist` :88-111, `test_LabelTA`
:114-132). FOSCTTM, the kNN label transfer and the centroid distances take
their distances from the K3 kernel (`ops/pairwise.py`) on `device`, in row
blocks of max(_FOSCTTM_BLOCK_ENTRIES // n, 256) rows (one block up to
`_FOSCTTM_BLOCK_ENTRIES` entries), exact at any N.

Not ported yet: occlusion/SHAP, `test_partial` and the figures (ROADMAP.md
item 13).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.dtypes import resolve_device
from .ops.distances import _as_device_f32
from .ops.pairwise import pairwise_euclidean

# Each row block of these metrics' distances holds about this many entries
# (1 GB of f32; jamie_tpu/evaluation.py:67)
_FOSCTTM_BLOCK_ENTRIES = 1 << 28


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
