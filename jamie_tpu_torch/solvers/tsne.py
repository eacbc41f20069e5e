"""Legacy t-SNE joint projection (project_mode='tsne') and the t-SNE
preclass embedding.

Reference parity: `jamie_tpu/solvers/tsne.py` — the UnionCom-inherited
flow of jamie/jamie.py:184-195: `joint_probabilities(dist, perplexity)`
per dataset, then a paired t-SNE that embeds both datasets while pulling
the Hungarian-matched pairs together; and `tsne_embed`, the preclass
model_pca='tsne'.

jamie_tpu compiles each loop (the perplexity bisection, the paired and
the single optimizer) into one `lax.fori_loop`; here each loop's step
updates static buffers with its counter on the device, and on the card it
is captured once as a CUDA graph and replayed (`core/graphs.StepGraph`);
on the CPU, and on the card inside `core/graphs.plain_loops()`, the same
step runs op by op. The squared
distances of the embedding come from K3 (`ops/pairwise.pairwise_euclidean`
with squared=True): on the card the CUDA kernel (3xTF32, float32-accurate,
zero diagonal), on the CPU its plain version. jamie_tpu writes them as an
(N, N, dim) broadcast that XLA fuses; eagerly that broadcast would
allocate N^2 dim floats per step. Adam is optax's (`train/trainer.
adam_update`: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
bias-corrected). The initial
embeddings come from a `torch.Generator` seeded with `seed` (jamie_tpu
draws them from a jax key), or from `init`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import graphs
from ..core.dtypes import resolve_device
from ..ops.pairwise import pairwise_euclidean
from ..train.trainer import adam_update


def _f32(x, device) -> torch.Tensor:
    """A host array or a tensor as a float32 tensor on `device`."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _calibrate_beta(D: torch.Tensor, perplexity: float,
                    tol_iters: int = 50) -> torch.Tensor:
    """Per-row precision (beta) bisection hitting the target entropy, in
    tol_iters fixed steps; returns the row-normalized conditional P
    (tsne.py:23-55). beta_min == 0 is the "unset" lower bound. One
    bisection step updates (beta, beta_min, beta_max) in place, jamie_tpu's
    `fori_loop` body; on the card it is captured as a CUDA graph and
    replayed (`core/graphs.StepGraph`), elsewhere it runs op by op."""
    n = D.shape[0]
    log_perp = torch.log(torch.tensor(float(perplexity), dtype=torch.float32,
                                      device=D.device))

    def entropy_and_p(beta):
        P = torch.exp(-D * beta[:, None])
        P.fill_diagonal_(0.0)
        sum_p = torch.clamp(P.sum(1), min=1e-12)
        H = torch.log(sum_p) + beta * (D * P).sum(1) / sum_p
        return H, P.div_(sum_p[:, None])

    beta = torch.ones(n, dtype=torch.float32, device=D.device)
    beta_min = torch.zeros_like(beta)
    beta_max = torch.full_like(beta, math.inf)

    def bisect():
        H, _ = entropy_and_p(beta)
        too_high = H > log_perp          # entropy too high: increase beta
        beta_min.copy_(torch.where(too_high, beta, beta_min))
        beta_max.copy_(torch.where(too_high, beta_max, beta))
        beta.copy_(torch.where(
            too_high,
            torch.where(torch.isinf(beta_max), beta * 2, (beta + beta_max) / 2),
            torch.where(torch.isneginf(beta_min) | (beta_min == 0),
                        beta / 2, (beta + beta_min) / 2)))
    graphs.steps_runner('tsne_beta', bisect, D.device).run(int(tol_iters))
    return entropy_and_p(beta)[1]


def joint_probabilities(dist, perplexity: float = 30.0,
                        device=None) -> torch.Tensor:
    """Symmetrized, perplexity-calibrated joint probabilities
    (unioncom.utils.joint_probabilities semantics, tsne.py:58-66), as a
    tensor on `device` (the card unless the caller asks for another).
    `dist` is a host array or a tensor of (non-squared) distances."""
    device = resolve_device(device)
    D = _f32(dist, device) ** 2
    P = _calibrate_beta(D, float(perplexity))
    P = (P + P.T) / (2 * P.shape[0])
    P.clamp_(min=1e-12)
    return P.div_(P.sum())


def _kl_grad(P: torch.Tensor, Y: torch.Tensor, exag) -> torch.Tensor:
    """Gradient of KL(exag P || Q) for the embedding Y (tsne.py:79-86):
    4 (diag(PQ 1) - PQ) Y with PQ = (exag P - Q) num. `exag` is a float or
    a 0-d tensor on Y's device. Every intermediate is (N, N) f32; the
    in-place steps are counted in `NN_PASSES_PER_KL_GRAD`."""
    num = pairwise_euclidean(Y, None, squared=True)
    num.add_(1.0).reciprocal_()
    num.fill_diagonal_(0.0)
    QmP = torch.div(num, num.sum()).clamp_(min=1e-12)
    if isinstance(exag, torch.Tensor):
        QmP.addcmul_(P, -exag)
    else:
        QmP.sub_(P, alpha=exag)
    QmP.mul_(num)                                  # -PQ
    return 4.0 * (QmP @ Y - QmP.sum(1, keepdim=True) * Y)


# (N, N) f32 reads and writes of one _kl_grad call, counted from the code:
# K3's output 1, add_ 2, reciprocal_ 2, sum 1, div 2, clamp_ 2, sub_ (or
# addcmul_) 3, mul_ 3, the (N, N) x (N, dim) product 1, the row sums 1.
NN_PASSES_PER_KL_GRAD = 18


def _tsne_optimize(P1, P2, Y1, Y2, pairs_x, pairs_y, align_weight: float,
                   n_iters: int, exaggeration_iters: int = 250,
                   lr: float = 0.5, exaggeration: float = 12.0):
    """Paired t-SNE, KL(P1||Q1) + KL(P2||Q2) + the pair alignment, with
    Adam (tsne.py:69-112). The early exaggeration anneals linearly from
    `exaggeration` to 1 over exaggeration_iters; both embeddings are
    mean-centred every step. Returns new (Y1, Y2) tensors.

    One iteration is jamie_tpu's `fori_loop` body on static buffers: the
    step counter lives on the device, the exaggeration and Adam's bias
    corrections are computed from it there, and nothing is read back. On
    the card it is captured once as a CUDA graph (K3's launches with it)
    and replayed; elsewhere it runs op by op."""
    n1, d = Y1.shape
    flat = torch.cat([Y1.reshape(-1), Y2.reshape(-1)]).float()
    Y1 = flat[:n1 * d].view(n1, d)
    Y2 = flat[n1 * d:].view(-1, d)
    px = torch.as_tensor(np.asarray(pairs_x), dtype=torch.long,
                         device=flat.device)
    py = torch.as_tensor(np.asarray(pairs_y), dtype=torch.long,
                         device=flat.device)
    scale = 2.0 * float(align_weight) / px.shape[0]
    mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
    i = torch.zeros((), dtype=torch.int32, device=flat.device)
    window = float(max(exaggeration_iters, 1))

    def iteration():
        frac = torch.clamp(i.float() / window, 0.0, 1.0)
        exag = exaggeration + (1.0 - exaggeration) * frac
        g1 = _kl_grad(P1, Y1, exag)
        g2 = _kl_grad(P2, Y2, exag)
        diff = (Y1[px] - Y2[py]).mul_(scale)
        g1.index_add_(0, px, diff)
        g2.index_add_(0, py, diff, alpha=-1)
        i.add_(1)
        adam_update(flat, torch.cat([g1.reshape(-1), g2.reshape(-1)]), mu,
                    nu, i, lr)
        Y1.sub_(Y1.mean(0))
        Y2.sub_(Y2.mean(0))
    graphs.steps_runner('tsne', iteration, flat.device).run(int(n_iters))
    return Y1, Y2


def _tsne_single(P, Y, n_iters: int, exaggeration_iters: int = 250,
                 lr: float = 0.5):
    """Single-dataset t-SNE with Adam and a hard 12x early exaggeration
    for the first exaggeration_iters steps (tsne.py:115-141), its switch a
    `where` on the device step counter; captured on the card as
    `_tsne_optimize` is."""
    Y = Y.float().clone()
    mu, nu = torch.zeros_like(Y), torch.zeros_like(Y)
    i = torch.zeros((), dtype=torch.int32, device=Y.device)

    def iteration():
        exag = torch.where(i < exaggeration_iters, 12.0, 1.0)
        g = _kl_grad(P, Y, exag)
        i.add_(1)
        adam_update(Y, g, mu, nu, i, lr)
        Y.sub_(Y.mean(0))
    graphs.steps_runner('tsne_single', iteration, Y.device).run(
        int(n_iters))
    return Y


def _initial(shapes, seed: int, init, device) -> list:
    """The initial embeddings: `init` (host arrays or tensors) where given,
    else 1e-4 N(0, 1) draws from one generator seeded with `seed`."""
    if init is not None:
        return [_f32(y, device) for y in init]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return [1e-4 * torch.randn(s, generator=gen, device=device,
                               dtype=torch.float32) for s in shapes]


def tsne_embed(data, n_components: int = 2, perplexity: float = 30.0,
               n_iters: int = 750, seed: int = 0, init=None,
               device=None) -> np.ndarray:
    """Embed one dataset with t-SNE on `device` (tsne.py:144-159): the
    counterpart of the reference's preclass model_pca='tsne' (sklearn
    TSNE(method='exact'), jamie/jamie.py:449-451). The euclidean distances
    go through K3."""
    from ..ops.distances import pairwise_distance
    device = resolve_device(device)
    dist = pairwise_distance(np.asarray(data, np.float32), 'euclidean',
                             device=device)
    P = joint_probabilities(dist, perplexity, device=device)
    (Y0,) = _initial([(P.shape[0], n_components)], seed,
                     None if init is None else [init], device)
    return _tsne_single(P, Y0, int(n_iters)).cpu().numpy()


def project_tsne(
    datasets: Sequence,
    P_joint: Sequence,
    pairs_x,
    pairs_y,
    output_dim: int = 2,
    n_iters: int = 1000,
    align_weight: float = 10.0,
    seed: int = 0,
    exaggeration: float = 12.0,
    exaggeration_iters: int = 250,
    lr: float = 0.5,
    init: Optional[Tuple] = None,
    device=None,
):
    """Embed both datasets with pair-aligned t-SNE on `device`; returns
    [Y1, Y2] as host arrays (tsne.py:162-193). `datasets` is accepted for
    signature parity; the embedding reads only the joint probabilities.
    `init` = (Y1, Y2) replaces the seeded initial embeddings."""
    del datasets
    device = resolve_device(device)
    P1, P2 = (_f32(p, device) for p in P_joint)
    Y1, Y2 = _initial([(P1.shape[0], output_dim), (P2.shape[0], output_dim)],
                      seed, init, device)
    Y1, Y2 = _tsne_optimize(P1, P2, Y1, Y2, pairs_x, pairs_y,
                            float(align_weight), int(n_iters),
                            exaggeration_iters=int(exaggeration_iters),
                            lr=float(lr), exaggeration=float(exaggeration))
    return [Y1.cpu().numpy(), Y2.cpu().numpy()]
