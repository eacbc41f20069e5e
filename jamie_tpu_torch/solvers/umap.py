"""UMAP embedding for the nonlinear preclass (model_pca='umap').

Reference parity: `jamie_tpu/solvers/umap.py`, the counterpart of the
reference's umap-learn `UMAP(n_components=dim).fit_transform`
(jamie/jamie.py:444-451), which neither package imports. Exact kNN from
the K3 euclidean distances, a bisection for each point's smooth-kNN sigma,
the fuzzy simplicial set W + W^T - W o W^T, and an SGD layout with the
fitted curve 1 / (1 + a d^{2b}), all on the device.

jamie_tpu's documented deviations from umap-learn are kept: dense expected
attraction (the membership-weighted force of all pairs each epoch, in
Gram form, with the pair coefficient clipped to 4/d), `neg_rate` uniform
negative samples per vertex per epoch (drawn from a `torch.Generator`
seeded with `seed`, where jamie_tpu uses a jax key) with a per-component
clip of 4, and a PCA initialization scaled into [-10, 10].

jamie_tpu compiles the bisection and the layout epochs as `fori_loop`s;
here each loop's step updates static buffers in place and is captured once
as a CUDA graph on the card and replayed (`core/graphs.steps_runner`), and
runs op by op on the CPU.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..core import graphs
from ..core.dtypes import resolve_device

# curve_fit(psi, ...) result for the default (min_dist=0.1, spread=1.0),
# the pair umap-learn ships as its default force curve
_AB_DEFAULT = (0.1, 1.0, 1.5769434603113077, 0.8950608779109733)


def fit_ab(min_dist: float = 0.1, spread: float = 1.0):
    """(a, b) of the low-dimensional similarity 1/(1 + a d^{2b}) fitted to
    the target membership curve: 1 for d <= min_dist, exp(-(d - min_dist)
    / spread) beyond (umap-learn's find_ab_params; umap.py:43-56)."""
    if (min_dist, spread) == _AB_DEFAULT[:2]:
        return _AB_DEFAULT[2:]
    from scipy.optimize import curve_fit

    d = np.linspace(0.0, 3.0 * spread, 300)
    target = np.where(d <= min_dist, 1.0, np.exp(-(d - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2.0 * b)),
                          d, target, p0=(1.0, 1.0), maxfev=10_000)
    return float(a), float(b)


def _weight_sum(shifted: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Each row's sum_j exp(-shifted_j / sigma)."""
    return torch.exp(-shifted / sigma[:, None]).sum(1)


def _smooth_knn(knn_d: torch.Tensor, iters: int = 64):
    """Per-point (rho, sigma): rho the nearest-neighbour distance, sigma
    solving sum_j exp(-max(0, d_j - rho) / sigma) = log2(k) by `iters`
    bisection steps, floored at 1e-3 x the mean kNN distance
    (umap.py:59-91). One bisection step updates (sigma, lo, hi) in place,
    jamie_tpu's `fori_loop` body: hi and lo from the old sigma, the new
    sigma from the new lo and hi and the old sigma. On the card it is
    captured as a CUDA graph and replayed (`core/graphs.StepGraph`),
    elsewhere it runs op by op."""
    k = knn_d.shape[1]
    rho = knn_d[:, 0]
    target = torch.log2(torch.tensor(float(k), device=knn_d.device))
    shifted = torch.clamp(knn_d - rho[:, None], min=0.0)
    sigma = torch.ones_like(rho)
    lo = torch.zeros_like(rho)
    hi = torch.full_like(rho, float('inf'))

    def bisect():
        too_big = _weight_sum(shifted, sigma) > target
        hi.copy_(torch.where(too_big, sigma, hi))
        lo.copy_(torch.where(too_big, lo, sigma))
        sigma.copy_(torch.where(
            too_big, (lo + sigma) / 2.0,
            torch.where(torch.isinf(hi), sigma * 2.0, (sigma + hi) / 2.0)))
    graphs.steps_runner('umap_sigma', bisect, knn_d.device).run(int(iters))
    return rho, torch.maximum(sigma, 1e-3 * knn_d.mean())


def _fuzzy_graph(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Dense symmetrized fuzzy simplicial set from a full distance matrix:
    membership exp(-(d - rho) / sigma) on each row's k nearest neighbours,
    then the probabilistic t-conorm A + A^T - A o A^T (umap.py:94-107)."""
    d = dist.clone()
    d.fill_diagonal_(float('inf'))
    neg, idx = torch.topk(-d, k, dim=1)
    knn_d = -neg
    rho, sigma = _smooth_knn(knn_d)
    w = torch.exp(-torch.clamp(knn_d - rho[:, None], min=0.0)
                  / sigma[:, None])
    A = torch.zeros_like(d).scatter_(1, idx, w)
    return A + A.T - A * A.T


def _repulsion(Y: torch.Tensor, idx: torch.Tensor, a: float, b: float,
               gamma: float = 1.0) -> torch.Tensor:
    """The repulsive force on each vertex from its negative partners
    Y[idx] (n, neg_rate), each component clipped to +-4 (umap.py:139-146)."""
    diffn = Y[:, None, :] - Y[idx]
    d2n = torch.clamp((diffn * diffn).sum(-1), min=1e-12)
    rep = (2.0 * gamma * b) / ((0.001 + d2n) * (a * d2n ** b + 1.0))
    return torch.clamp(rep[:, :, None] * diffn, -4.0, 4.0).sum(1)


def _alpha(i: torch.Tensor, rcp: torch.Tensor, lr0: float) -> torch.Tensor:
    """Epoch i's float32 learning rate lr0 (1 - i / n_epochs) from the
    int32 counter i, bit for bit as jamie_tpu's jitted loop computes it
    (umap.py:130): XLA folds the division by the constant n_epochs into a
    product with its float32 reciprocal `rcp` (held in float64) and fuses
    1 - i rcp into one rounding. In float64, 1 - i rcp is exact (i and
    n_epochs below 2^24), so one rounding to float32 gives the fused
    result."""
    return lr0 * (1.0 - i.double() * rcp).float()


def _optimize_layout(W: torch.Tensor, Y: torch.Tensor, gen, n_epochs: int,
                     a: float, b: float, neg_rate: int = 5, lr0: float = 1.0,
                     gamma: float = 1.0) -> torch.Tensor:
    """UMAP layout SGD (umap.py:110-150): dense expected attraction in
    Gram form, d^2 from Y Y^T and the force (diag(C 1) - C) Y with the pair
    coefficient C clipped to +-4/d; `neg_rate` uniform negative partners
    per vertex per epoch from `gen`, each force component clipped to +-4;
    the learning rate annealed linearly to 0. Returns a new tensor.

    One epoch is jamie_tpu's `fori_loop` body on static buffers: both
    forces from the old Y, then Y updated in place, the learning rate from
    an int32 epoch counter on the device. On the card it is captured once
    as a CUDA graph and replayed, with `gen` registered so that each replay
    draws new partners; elsewhere it runs op by op."""
    n = Y.shape[0]
    Y = Y.float().clone()
    i = torch.zeros((), dtype=torch.int32, device=Y.device)
    rcp = torch.tensor(float(np.float32(1) / np.float32(n_epochs)),
                       dtype=torch.float64, device=Y.device)

    def epoch():
        alpha = _alpha(i, rcp, lr0)
        sq = (Y * Y).sum(1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (Y @ Y.T),
                         min=1e-12)
        att = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2 ** b + 1.0)
        lim = 4.0 * torch.rsqrt(d2)
        C = torch.minimum(torch.maximum(att * W, -lim), lim)
        g = C.sum(1)[:, None] * Y - C @ Y
        idx = torch.randint(0, n, (n, neg_rate), generator=gen,
                            device=Y.device)
        Y.add_(alpha * (g + _repulsion(Y, idx, a, b, gamma)))
        i.add_(1)
    graphs.steps_runner('umap_layout', epoch, Y.device,
                        generators=(gen,) if neg_rate > 0 else ()
                        ).run(int(n_epochs))
    return Y


def umap_embed(data, n_components: int = 2, n_neighbors: int = 15,
               min_dist: float = 0.1, spread: float = 1.0,
               n_epochs: Optional[int] = None, neg_rate: int = 5,
               seed: int = 0, device=None) -> np.ndarray:
    """Embed one dataset with UMAP on `device` (umap.py:153-190), with
    umap-learn's defaults for every exposed knob; returns a host array.
    The bisection and the layout run captured on the card."""
    from ..ops.distances import pairwise_distance
    from ..preprocess import PCA

    X = np.asarray(data, np.float32)
    n = X.shape[0]
    if n < 3:
        warnings.warn('umap on <3 samples: returning zero embedding')
        return np.zeros((n, n_components), np.float32)
    device = resolve_device(device)
    k = int(min(n_neighbors, n - 1))
    if n_epochs is None:
        n_epochs = 500 if n <= 10_000 else 200   # umap-learn's size rule

    W = _fuzzy_graph(pairwise_distance(X, 'euclidean', device=device), k)
    a, b = fit_ab(float(min_dist), float(spread))

    # PCA init scaled into the [-10, 10] box, plus tie-breaking noise
    dim = int(min(n_components, min(X.shape)))
    scores = PCA(n_components=dim, device=device).fit_transform(X)
    Y0 = torch.zeros((n, n_components), dtype=torch.float32, device=device)
    Y0[:, :dim] = torch.as_tensor(scores, device=device)[:, :dim]
    Y0 *= 10.0 / max(float(Y0.abs().max()), 1e-12)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    Y0 += 1e-4 * torch.randn((n, n_components), generator=gen, device=device)
    return _optimize_layout(W, Y0, gen, int(n_epochs), float(a), float(b),
                            neg_rate=int(neg_rate)).cpu().numpy()
