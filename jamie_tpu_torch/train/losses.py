"""The four-term JAMIE training objective.

Reference parity: `jamie_tpu/train/losses.py` (jamie/jamie.py:614-728):
  (i)   KL, mean-reduced per modality, sigmoid-annealed (the caller applies
        the 32e-3 scale and `kl_anneal`)
  (ii)  MSE reconstruction
  (iii) latent consistency: squared matched-row difference between each
        modality's sampled latent and its combined latent, x32,
        dim-normalized (the diagonal of the reference's BxB matrix,
        computed directly)
  (iv)  F reconstruction ||combined0 - F combined1||^2

Dtypes promote as in jamie_tpu (losses.py:56, 90): the data is cast to the
reconstruction's dtype, F to the combined latents'.

`count`: on a batch split over a mesh's 'data' axis each rank holds some
rows, and every mean over the batch is a mean over the whole batch: the
local rows' sum divided by the global row count. The trainer all-reduces
the four terms (each rank's share sums to the whole batch's loss).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

LOSS_NAMES = ('KL', 'Rec', 'CosSim', 'F')


def kl_anneal(epoch, min_epochs: int, epoch_dnn: int):
    """Sigmoid annealing weight in [0, 1] with midpoint c (jamie.py:630-631).
    A tensor epoch (the trainer's device epoch counter) gives a float32
    tensor on its device, computed as jamie_tpu computes it in its jitted
    chunk; an int gives a Python float."""
    c = (min_epochs / 2) if min_epochs > 0 else (epoch_dnn / 2)
    if isinstance(epoch, torch.Tensor):
        e = epoch.to(torch.float32)
        return 1.0 / (1.0 + torch.exp(-5.0 * (e - c) / c))
    return 1.0 / (1.0 + math.exp(-5.0 * (epoch - c) / c))


def batch_mean(v: torch.Tensor, count: Optional[int] = None):
    """The mean of per-row values over the batch: v.mean(), or the local
    rows' share sum(v) / count of a batch of `count` rows."""
    return torch.mean(v) if count is None else torch.sum(v) / count


def kl_divergence(mus: Sequence[torch.Tensor],
                  logvars: Sequence[torch.Tensor],
                  count: Optional[int] = None):
    """Sum over modalities of the mean-reduced KL(q||N(0,1)). Like
    jamie_tpu, pairs each modality's mu with its own logvar (the
    reference pairs them with the last modality's — an upstream bug)."""
    total = 0.0
    for mu, logvar in zip(mus, logvars):
        total = total + batch_mean(-0.5 * torch.mean(
            1 + logvar - mu * mu - torch.exp(logvar), dim=1), count)
    return total


def reconstruction_loss(reconstructed: Sequence[torch.Tensor],
                        data: Sequence[torch.Tensor],
                        count: Optional[int] = None):
    """Sum over modalities of MSE (jamie.py:637-642)."""
    total = 0.0
    for rec, x in zip(reconstructed, data):
        total = total + batch_mean(
            torch.mean((rec - x.to(rec.dtype)) ** 2, dim=1), count)
    return total


def _diag_sq_diff(a: torch.Tensor, b: torch.Tensor, method: str):
    """Squared row-matched difference (no sqrt on the euclidean path: the
    loss only consumes diff^2, and sqrt at 0 has a NaN gradient)."""
    if method == 'cosine':
        sim = torch.sum(a * b, dim=1) / (
            torch.linalg.norm(a, dim=1) * torch.linalg.norm(b, dim=1))
        return (1.0 - sim) ** 2
    if method == 'euclidean':
        return torch.sum((a - b) ** 2, dim=1)
    raise ValueError(f'Unknown dist_method {method!r}')


def latent_consistency_loss(embedded: Sequence[torch.Tensor],
                            combined: Sequence[torch.Tensor],
                            dist_method: str = 'euclidean',
                            count: Optional[int] = None):
    """32 x the dim-normalized squared matched-row difference."""
    d0 = _diag_sq_diff(embedded[0], combined[0], dist_method)
    d1 = _diag_sq_diff(embedded[1], combined[1], dist_method)
    return 32.0 * (batch_mean(d0, count) / embedded[0].shape[1]
                   + batch_mean(d1, count) / embedded[1].shape[1])


def f_reconstruction_loss(combined0: torch.Tensor, combined1: torch.Tensor,
                          F: torch.Tensor, count: Optional[int] = None):
    """||combined0 - F @ combined1||^2, mean-reduced (jamie.py:663-667).
    With a split batch, combined0 and F are this rank's rows and
    combined1 the whole batch's."""
    diff = combined0 - F.to(combined1.dtype) @ combined1
    return batch_mean(torch.mean(diff * diff, dim=1), count)


def row_normalize(M: torch.Tensor):
    """Row-normalize with zero-row guard (jamie.py:586-599)."""
    s = torch.sum(M, dim=1)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return M / s[:, None]


def col_normalize(M: torch.Tensor):
    """Column-normalize with zero-column guard (a documented deviation from
    the reference, whose zero column would give NaN)."""
    s = torch.sum(M, dim=0)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return M / s[None, :]
