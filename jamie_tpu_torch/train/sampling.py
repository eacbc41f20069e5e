"""Batch sampling for the three correspondence regimes.

Reference parity: `jamie_tpu/train/sampling.py` (jamie/jamie.py:517-583):
- 'diag'   — P is the identity: one index set shared by both modalities;
- 'hybrid' — partial priors: each slot is a whole matched pair with
             probability true_ratio (0.8), else independent random rows;
- 'zeros'  — no priors: independent sampling per modality.

`make_sampler` draws one step's batch (jamie_tpu's per-step sampler);
`make_epoch_sampler`, which the trainer uses, draws all of an epoch's batch
indices at once: for
diag/zeros one permutation per epoch cut into consecutive wrap-around
windows (torch DataLoader(shuffle=True, drop_last=True) semantics: no cell
repeats within an epoch until the permutation wraps), for hybrid one
(L, B) batch of draws. Indices come from a `torch.Generator` on the
sampling device, so the stream differs from jamie_tpu's jax keys.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def detect_sampling_method(P: np.ndarray) -> str:
    """Pick the regime from the prior matrix P (jamie.py:518-534)."""
    P = np.asarray(P)
    if P.shape[0] == P.shape[1] and np.abs(P - np.eye(P.shape[0])).sum() == 0:
        return 'diag'
    if np.abs(P).sum() != 0:
        return 'hybrid'
    return 'zeros'


def _draw(gen, n_rows: int, batch_size: int, device) -> torch.Tensor:
    """batch_size indices in [0, n_rows): without replacement when the
    batch fits (a permutation's prefix), with replacement otherwise."""
    if batch_size <= n_rows:
        return torch.randperm(n_rows, generator=gen,
                              device=device)[:batch_size]
    return torch.randint(0, n_rows, (batch_size,), generator=gen,
                         device=device)


def make_sampler(
    method: str,
    rows: Sequence[int],
    batch_size: int,
    corr_pairs: Optional[np.ndarray] = None,
    true_ratio: float = 0.8,
    device=None,
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """sample(generator, pairs=None) -> (idx0, idx1), each (batch_size,)
    int64 on `device`: one step's batch. `pairs` replaces the matched-pair
    table given at build time (jamie_tpu's call-time operand)."""
    rows = tuple(int(r) for r in rows)
    B = int(batch_size)
    device = torch.device('cpu') if device is None else torch.device(device)

    if method == 'diag':
        def sample(gen, pairs=None):
            idx = _draw(gen, rows[0], B, device)
            return idx, idx
        return sample

    if method == 'zeros':
        def sample(gen, pairs=None):
            return (_draw(gen, rows[0], B, device),
                    _draw(gen, rows[1], B, device))
        return sample

    if method == 'hybrid':
        if corr_pairs is None or len(corr_pairs) == 0:
            raise ValueError('hybrid sampling requires nonzero-P matched pairs')
        default_pairs = torch.as_tensor(np.asarray(corr_pairs, np.int64),
                                        device=device)

        def sample(gen, pairs=None):
            table = (default_pairs if pairs is None else torch.as_tensor(
                np.asarray(pairs, np.int64), device=device))
            take_corr = torch.rand(B, generator=gen, device=device) < true_ratio
            pair_idx = torch.randint(0, table.shape[0], (B,), generator=gen,
                                     device=device)
            r0 = torch.randint(0, rows[0], (B,), generator=gen, device=device)
            r1 = torch.randint(0, rows[1], (B,), generator=gen, device=device)
            return (torch.where(take_corr, table[pair_idx, 0], r0),
                    torch.where(take_corr, table[pair_idx, 1], r1))
        return sample

    raise ValueError(f'Sampling method {method} does not exist')


def make_epoch_sampler(
    method: str,
    rows: Sequence[int],
    batch_size: int,
    len_dataloader: int,
    corr_pairs: Optional[np.ndarray] = None,
    true_ratio: float = 0.8,
    device=None,
) -> Callable[[torch.Generator], Tuple[torch.Tensor, torch.Tensor]]:
    """sample_epoch(generator) -> (idx0, idx1), each (len_dataloader,
    batch_size) int64 on `device`."""
    rows = tuple(int(r) for r in rows)
    L, B = int(len_dataloader), int(batch_size)
    device = torch.device('cpu') if device is None else torch.device(device)

    def _epoch_windows(gen, n):
        if B > n:   # with-replacement regime
            return torch.randint(0, n, (L, B), generator=gen, device=device)
        perm = torch.randperm(n, generator=gen, device=device)
        pos = torch.arange(L * B, device=device) % n
        return perm[pos.reshape(L, B)]

    if method == 'diag':
        def sample_epoch(gen):
            idx = _epoch_windows(gen, rows[0])
            return idx, idx
        return sample_epoch

    if method == 'zeros':
        def sample_epoch(gen):
            return _epoch_windows(gen, rows[0]), _epoch_windows(gen, rows[1])
        return sample_epoch

    if method == 'hybrid':
        if corr_pairs is None or len(corr_pairs) == 0:
            raise ValueError('hybrid sampling requires nonzero-P matched pairs')
        pairs = torch.as_tensor(np.asarray(corr_pairs, np.int64),
                                device=device)

        def sample_epoch(gen):
            take_corr = torch.rand((L, B), generator=gen,
                                   device=device) < true_ratio
            pair_idx = torch.randint(0, pairs.shape[0], (L, B),
                                     generator=gen, device=device)
            r0 = torch.randint(0, rows[0], (L, B), generator=gen,
                               device=device)
            r1 = torch.randint(0, rows[1], (L, B), generator=gen,
                               device=device)
            idx0 = torch.where(take_corr, pairs[pair_idx, 0], r0)
            idx1 = torch.where(take_corr, pairs[pair_idx, 1], r1)
            return idx0, idx1
        return sample_epoch

    raise ValueError(f'Sampling method {method} does not exist')
