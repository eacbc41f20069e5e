"""Comparison-method harness: the alignment baselines the paper notebooks
benchmark JAMIE against.

Reference parity: `jamie_tpu/compare.py` — the five methods of the
notebooks' `mmd_combine` (e.g. scGEM.ipynb cells 14-18): NLMA / LMA
(ManiNetCluster nonlinear / linear manifold alignment), CCA (the linear
joint eigenproblem on a correspondence-only graph), MMD-MA (Liu & Noble
2019 kernel matching) and UnionCom, each scored with FOSCTTM and LTA.

On `device` (the card unless the caller asks for another): the kNN graphs'
squared distances come from K3 (`ops/distances.py`), with the neighbour
selection on the host as in jamie_tpu; the eigen, Cholesky and triangular
solves are `torch.linalg` on the device; MMD-MA's hyperparameter grid x
restart batch (jax's vmap) is a leading batch dimension of plain tensors,
optimized by one optax-style Adam with autograd, its iteration captured as
a CUDA graph on the card and replayed (jamie_tpu's `fori_loop`). UnionCom is this package's
own `JAMIE(project_mode='tsne')`, through K1 and K3.

Deliberate deviation: where the f32 Cholesky of LMA's (and CCA's)
B = Z^T D Z fails, which happens when a modality has more features than its
rows give rank, `_lma_eig` raises a ValueError; jamie_tpu returns NaN
embeddings there.

Each embedder takes `dataset = [X0, X1]` (row-aligned unless noted) and
returns `[emb0, emb1]` host arrays with `output_dim` columns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core import graphs
from .core.dtypes import resolve_device
from .nn_funcs import _symmetric_knn_adjacency
from .ops.distances import pairwise_distance
from .train.trainer import adam_update


def _binary_knn(X, k: int = 5, device=None) -> np.ndarray:
    """Symmetric unweighted kNN adjacency (host array). Gaussian kernels on
    z-scored high-dimensional data underflow to ~0, which unbalances the
    joint graph; the binary graph with a strong correspondence coupling is
    what reproduces the reference NLMA numbers."""
    d = pairwise_distance(np.asarray(X, np.float32), 'sqeuclidean',
                          device=device).cpu().numpy()
    np.fill_diagonal(d, np.inf)
    idx = np.argpartition(d, k, axis=1)[:, :k]
    return _symmetric_knn_adjacency(np.ones_like(d), idx)


def _correspondence(P, n0: int, n1: int, device) -> torch.Tensor:
    if P is None:
        assert n0 == n1, 'unaligned data needs an explicit correspondence P'
        return torch.eye(n0, dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(P, np.float32), device=device)


def _block(a, b, c, d) -> torch.Tensor:
    return torch.cat((torch.cat((a, b), 1), torch.cat((c, d), 1)), 0)


def _laplacian_pieces(dataset, P, coupling, k, device):
    """Joint graph W = [[Wx, coupling*P], [coupling*P^T, Wy]] and its
    degree vector (reference nn_funcs.py:104-131 semantics)."""
    n0, n1 = dataset[0].shape[0], dataset[1].shape[0]
    Wx, Wy = (torch.as_tensor(_binary_knn(x, k, device), device=device)
              for x in dataset)
    P = _correspondence(P, n0, n1, device)
    W = _block(Wx, coupling * P, coupling * P.T, Wy)
    return W, W.sum(1), n0


def _nlma_eig(W: torch.Tensor, d: torch.Tensor,
              output_dim: int) -> torch.Tensor:
    d_isqrt = 1.0 / torch.sqrt(torch.clamp(d, min=1e-12))
    L_sym = (torch.eye(W.shape[0], device=W.device)
             - (d_isqrt[:, None] * W) * d_isqrt[None, :])
    _, vecs = torch.linalg.eigh(L_sym)
    # skip the trivial constant eigenvector(s); rescale to the random-walk
    # eigenvectors (generalized problem L f = lambda D f)
    F = (vecs * d_isqrt[:, None])[:, 1:output_dim + 1]
    return F / torch.clamp(torch.linalg.vector_norm(F, dim=0, keepdim=True),
                           min=1e-12)


def nlma_embed(dataset: Sequence[np.ndarray], P=None, output_dim: int = 32,
               coupling: float = 5.0, k: int = 5,
               device=None) -> List[np.ndarray]:
    """Nonlinear manifold alignment (mmd_combine method='maninetcluster',
    alignment='nonlinear manifold aln'; scGEM.ipynb cell 14): joint-graph
    Laplacian eigenmaps with the correspondence as the cross-block."""
    device = resolve_device(device)
    W, d, n0 = _laplacian_pieces(dataset, P, coupling, k, device)
    F = _nlma_eig(W, d, int(output_dim)).contiguous().cpu().numpy()
    return [F[:n0], F[n0:]]


def _lma_eig(Z: torch.Tensor, W: torch.Tensor, d: torch.Tensor,
             output_dim: int) -> torch.Tensor:
    """Projection directions of the generalized eigenproblem A v = l B v,
    A = Z^T L Z, B = Z^T D Z (plus a 1e-6 relative ridge), by Cholesky
    whitening."""
    A = Z.T @ ((torch.diag(d) - W) @ Z)
    B = Z.T @ (d[:, None] * Z)
    eye = torch.eye(B.shape[0], device=B.device)
    B = B + 1e-6 * torch.trace(B) / B.shape[0] * eye
    C, info = torch.linalg.cholesky_ex(B)
    if int(info) != 0:
        raise ValueError(
            f'the generalized eigenproblem is singular: B = Z^T D Z '
            f'({B.shape[0]} x {B.shape[0]}) is not positive definite in '
            f'float32 (Cholesky failed at column {int(info)}). The feature '
            f'count f0 + f1 = {B.shape[0]} exceeds the rank the '
            f'{Z.shape[0]} rows give; reduce each modality first, e.g. PCA '
            f'to fewer components than it has rows.')
    Ci = torch.linalg.solve_triangular(C, eye, upper=False)
    _, vecs = torch.linalg.eigh(Ci @ A @ Ci.T)
    V = Ci.T @ vecs[:, :output_dim]
    return V / torch.clamp(torch.linalg.vector_norm(V, dim=0, keepdim=True),
                           min=1e-12)


def _centered(dataset, device):
    X0, X1 = (torch.as_tensor(np.asarray(x, np.float32), device=device)
              for x in dataset)
    return X0 - X0.mean(0), X1 - X1.mean(0)


def _block_features(X0: torch.Tensor, X1: torch.Tensor) -> torch.Tensor:
    """The stacked block-diagonal feature matrix [[X0, 0], [0, X1]]."""
    return _block(X0, X0.new_zeros((X0.shape[0], X1.shape[1])),
                  X1.new_zeros((X1.shape[0], X0.shape[1])), X1)


def _project(X0, X1, V) -> List[np.ndarray]:
    f0 = X0.shape[1]
    return [(X0 @ V[:f0]).cpu().numpy(), (X1 @ V[f0:]).cpu().numpy()]


def lma_embed(dataset: Sequence[np.ndarray], P=None, output_dim: int = 32,
              coupling: float = 5.0, k: int = 5,
              device=None) -> List[np.ndarray]:
    """Linear manifold alignment (mmd_combine method='maninetcluster',
    alignment='manifold aln'): the NLMA objective restricted to
    per-modality linear maps, solved as a generalized eigenproblem on the
    stacked block-diagonal feature matrix."""
    device = resolve_device(device)
    W, d, _ = _laplacian_pieces(dataset, P, coupling, k, device)
    X0, X1 = _centered(dataset, device)
    V = _lma_eig(_block_features(X0, X1), W, d, int(output_dim))
    return _project(X0, X1, V)


def cca_embed(dataset: Sequence[np.ndarray], P=None, output_dim: int = 32,
              device=None) -> List[np.ndarray]:
    """CCA as the reference ran it (mmd_combine method='maninetcluster',
    alignment='cca'; scGEM.ipynb cell 16): ManiNetCluster's 'cca' is the
    linear joint eigenproblem of lma_embed with a correspondence-only joint
    graph W = [[0, P], [P^T, 0]] (mu = 1, no within-modality kNN edges),
    not classical covariance-whitening CCA."""
    device = resolve_device(device)
    n0, n1 = dataset[0].shape[0], dataset[1].shape[0]
    P = _correspondence(P, n0, n1, device)
    X0, X1 = _centered(dataset, device)
    W = _block(P.new_zeros((n0, n0)), P, P.T, P.new_zeros((n1, n1)))
    V = _lma_eig(_block_features(X0, X1), W, W.sum(1), int(output_dim))
    return _project(X0, X1, V)


def _rbf_mmd2(X: torch.Tensor, Y: torch.Tensor,
              sigma: torch.Tensor) -> torch.Tensor:
    """Biased RBF MMD^2 between the rows of X and Y, batched over the
    leading dimension (sigma: one bandwidth per batch entry)."""
    def k(a, b):
        d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
              - 2 * a @ b.transpose(-1, -2))
        return torch.exp(-d2 / (2 * sigma[:, None, None] ** 2))
    return (k(X, X).mean((-1, -2)) + k(Y, Y).mean((-1, -2))
            - 2 * k(X, Y).mean((-1, -2)))


def _mmdma_opt(K1, K2, a1, a2, sigma, lambda1, lambda2, output_dim: int,
               n_iters: int, lr: float = 1e-4):
    """MMD-MA (Liu & Noble 2019): learn alpha_i so that K_i alpha_i match in
    MMD, with orthogonality and distortion penalties, for a batch of runs
    at once: a1 (B, n1, p), a2 (B, n2, p), and sigma, lambda1, lambda2 (B,)
    tensors. Each run's loss depends on its own slice only, so the gradient
    of the summed loss is every run's own gradient, and one optax.adam(lr)
    (b1 0.9, b2 0.999, eps 1e-8; elementwise) steps them all. Returns the
    embeddings (B, n, p) and each run's final MMD term.

    One iteration is jamie_tpu's `fori_loop` body on static buffers (the
    params, leaves that require grad, and their moments): the gradient by
    autograd, then Adam with its bias corrections from an int32 step
    counter on the device. On the card it is captured once as a CUDA graph
    and replayed (`core/graphs.StepGraph`); elsewhere it runs op by op."""
    n1, n2 = K1.shape[0], K2.shape[0]
    I_p = torch.eye(output_dim, device=K1.device)

    def loss_fn(a1, a2):
        E1, E2 = K1 @ a1, K2 @ a2
        pen = (((a1.transpose(-1, -2) @ E1 - I_p) ** 2).sum((-1, -2))
               + ((a2.transpose(-1, -2) @ E2 - I_p) ** 2).sum((-1, -2)))
        dis = (((K1 - E1 @ E1.transpose(-1, -2)) ** 2).sum((-1, -2))
               / (n1 * n1)
               + ((K2 - E2 @ E2.transpose(-1, -2)) ** 2).sum((-1, -2))
               / (n2 * n2))
        return (_rbf_mmd2(E1, E2, sigma) + lambda1 * pen
                + lambda2 * dis).sum()

    params = [a.detach().clone().requires_grad_(True) for a in (a1, a2)]
    moments = [(torch.zeros_like(a), torch.zeros_like(a)) for a in params]
    count = torch.zeros(1, dtype=torch.int32, device=K1.device)

    def step():
        grads = torch.autograd.grad(loss_fn(*params), params)
        count.add_(1)
        with torch.no_grad():
            for a, g, (mu, nu) in zip(params, grads, moments):
                adam_update(a, g, mu, nu, count, lr)
    graphs.steps_runner('mmdma', step, K1.device).run(int(n_iters))
    with torch.no_grad():
        E1, E2 = K1 @ params[0], K2 @ params[1]
        return E1, E2, _rbf_mmd2(E1, E2, sigma)


def mmdma_embed(dataset: Sequence[np.ndarray], output_dim: int = 32,
                n_iters: int = 10001, seed: int = 0,
                n_restarts: int = 3,
                sigma_scales: Sequence[float] = (0.25, 1.0, 4.0),
                lambda1_grid: Sequence[float] = (1e-2, 1e-3),
                lambda2_grid: Sequence[float] = (1e-3, 1e-4),
                init=None, device=None) -> List[np.ndarray]:
    """MMD-MA on row-normalized linear kernels, matching the notebooks'
    preparation (scGEM.ipynb cell 17: d /= ||d||_row; K = d d^T;
    max_iterations=10001).

    Every (sigma, lambda1, lambda2) grid point runs `n_restarts` random
    initializations, all as one batched optimization; the winner is the
    run with the smallest MMD at a common bandwidth. The bandwidth grid is
    centered on the median pairwise distance of the first run's initial
    embeddings (median heuristic; a RandomState(0) subsample of 512 rows
    past 512). The initial a1 and a2, U[0, 1) * 1e-2 of shapes (B, n_i, p),
    come from a CPU `torch.Generator` seeded with `seed` (so the card and
    the CPU start alike), or from `init` = (a1, a2), host arrays or CPU
    tensors. The host work (the kernels, the draws, the median heuristic,
    the selection) stays outside the optimization, as in jamie_tpu; the
    optimization runs captured on the card."""
    device = resolve_device(device)
    Ks = []
    for d in dataset:
        d = np.asarray(d, np.float32)
        d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
        dt = torch.as_tensor(d, device=device)
        Ks.append(dt @ dt.T)
    p = int(output_dim)
    n_grid = len(sigma_scales) * len(lambda1_grid) * len(lambda2_grid)
    B = n_grid * int(n_restarts)
    if init is None:
        gen = torch.Generator().manual_seed(int(seed))
        init = [torch.rand((B, K.shape[0], p), generator=gen) * 1e-2
                for K in Ks]
    a1, a2 = (torch.as_tensor(np.array(a, np.float32), device=device)
              for a in init)

    # Median heuristic on the first run's initial embeddings
    E0 = torch.cat([Ks[0] @ a1[0], Ks[1] @ a2[0]]).cpu().numpy()
    if len(E0) > 512:
        E0 = E0[np.random.RandomState(0).choice(len(E0), 512,
                                                replace=False)]
    d2 = ((E0[:, None] - E0[None]) ** 2).sum(-1)
    med = float(np.sqrt(np.median(d2[d2 > 0])))

    grid = [(max(ss * med, 1e-6), l1, l2) for ss in sigma_scales
            for l1 in lambda1_grid for l2 in lambda2_grid
            for _ in range(int(n_restarts))]
    sigmas, l1s, l2s = (torch.tensor(col, dtype=torch.float32, device=device)
                        for col in zip(*grid))
    E1, E2, _ = _mmdma_opt(Ks[0], Ks[1], a1, a2, sigmas, l1s, l2s, p,
                           int(n_iters))
    # Selection must use a COMMON bandwidth: each run's own final MMD is
    # not comparable across sigmas (as sigma grows every kernel value
    # tends to 1 and MMD to 0 regardless of alignment), so every run's
    # final embeddings are re-scored at the median-heuristic sigma.
    score = _rbf_mmd2(E1, E2, torch.full((B,), med, device=device))
    best = int(torch.argmin(score))
    return [E1[best].cpu().numpy(), E2[best].cpu().numpy()]


def unioncom_embed(dataset: Sequence[np.ndarray], output_dim: int = 32,
                   **kwargs) -> List[np.ndarray]:
    """UnionCom (mmd_combine method='unioncom'; scGEM.ipynb cell 18): the
    prime-dual F + Hungarian pairs + pair-aligned t-SNE pipeline, this
    package's `JAMIE(project_mode='tsne')` run unsupervised, with the
    UnionCom package's defaults: geodesic distances, epoch_pd=20000 solver
    iterations and a 3000-iteration t-SNE. kwargs go to JAMIE (device=
    included)."""
    from .estimator import JAMIE
    jm = JAMIE(project_mode='tsne', output_dim=output_dim,
               distance_mode=kwargs.pop('distance_mode', 'geodesic'),
               epoch_pd=kwargs.pop('epoch_pd', 20000),
               tsne_iters=kwargs.pop('tsne_iters', 3000),
               **kwargs)
    return jm.fit_transform(dataset=list(dataset))


METHODS = {
    'NLMA': nlma_embed,
    'LMA': lma_embed,
    'CCA': cca_embed,
    'MMD-MA': mmdma_embed,
    'UnionCom': unioncom_embed,
}


def compare_methods(
    dataset: Sequence[np.ndarray],
    labels: Optional[Sequence[np.ndarray]] = None,
    methods: Sequence[str] = ('NLMA', 'CCA', 'MMD-MA'),
    output_dim: int = 32,
    method_kwargs: Optional[Dict[str, dict]] = None,
    device=None,
) -> Dict[str, dict]:
    """Run each baseline on `device` and score it like the notebooks'
    accuracy cells (FOSCTTM via test_closer, LTA via the kNN label transfer
    when labels are given). Returns {method: {'embeddings', 'foscttm',
    'lta'}}."""
    from .evaluation import knn_label_transfer_accuracy, test_closer
    method_kwargs = method_kwargs or {}
    out = {}
    for name in methods:
        emb = METHODS[name](dataset, output_dim=output_dim, device=device,
                            **method_kwargs.get(name, {}))
        entry = {'embeddings': emb}
        if emb[0].shape[0] == emb[1].shape[0]:
            entry['foscttm'] = float(test_closer(emb, device=device))
        if labels is not None:
            entry['lta'] = float(knn_label_transfer_accuracy(
                emb, labels, device=device)[0])
        out[name] = entry
    return out
