"""Evaluation metrics.

Reference parity: `jamie_tpu/evaluation.py:41-170` (jamie/evaluation.py
`test_closer` :65-85, `test_label_dist` :88-111, `test_LabelTA`
:114-132). FOSCTTM, the kNN label transfer and the centroid distances take
their distances from the K3 kernel (`ops/pairwise.py`) on `device`.

Not ported yet: the row-blocked FOSCTTM / kNN past
`_FOSCTTM_BLOCK_ENTRIES`, occlusion/SHAP, `test_partial` and the figures
(ROADMAP.md item 13).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.dtypes import resolve_device
from .ops.pairwise import pairwise_euclidean

# jamie_tpu computes these metrics in one N x N piece up to this many
# entries and in row blocks beyond (evaluation.py:67)
_FOSCTTM_BLOCK_ENTRIES = 1 << 28


def _device_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _check_unblocked(nq: int, nf: int, what: str) -> None:
    if nq * nf > _FOSCTTM_BLOCK_ENTRIES:
        raise NotImplementedError(
            f'{what} over {nq} x {nf} entries needs the row-blocked route: '
            'ROADMAP.md item 13')


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
        a = _device_f32(integrated_data[0], device)
        b = _device_f32(integrated_data[1], device)
        n = a.shape[0]
        _check_unblocked(n, n, 'FOSCTTM')
        d = pairwise_euclidean(a, b, squared=True)
        diag = torch.diagonal(d)
        closer = (torch.sum(d < diag[:, None]) + torch.sum(d < diag[None, :]))
        foscttm = float(closer) / (2.0 * n * n)
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
            _device_f32(centroids, resolve_device(device)),
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
    fit_x = _device_f32(integrated_data[1], device)
    query = _device_f32(integrated_data[0], device)
    uniq, fit_labels = np.unique(np.asarray(datatype[1]), return_inverse=True)
    k = min(k, fit_x.shape[0])
    _check_unblocked(query.shape[0], fit_x.shape[0], 'kNN label transfer')
    d = pairwise_euclidean(query, fit_x, squared=True)
    nn_idx = torch.topk(d, k, dim=1, largest=False).indices
    votes = torch.as_tensor(fit_labels, device=device)[nn_idx]   # (nq, k)
    counts = torch.nn.functional.one_hot(votes, len(uniq)).sum(1)
    pred = torch.argmax(counts, dim=1).cpu().numpy()
    acc = float(np.mean(uniq[pred] == np.asarray(datatype[0])))
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
