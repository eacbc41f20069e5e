"""Experimental low-rank correspondence (corr_method='jamie').

Reference parity: `jamie_tpu/solvers/lowrank.py`, itself `JAMIE.com_corr`
(jamie/jamie.py:252-312), a work-in-progress factorization the reference
warns "does not produce reliable results" (jamie.py:242-246); kept for API
parity. Two phases of `epochs` steps each, every step one
`torch.autograd.grad` through three small matmul chains and an update with
optax's RMSprop (decay 0.9, g / sqrt(nu + 1e-8), nu from 0), then a top-k
binarization of each row. The initial factors and the dropout-style masks
come from a `torch.Generator` seeded with `seed` (jamie_tpu draws them
from a jax key). jamie_tpu runs each phase as one `lax.fori_loop`; here
each phase's step is captured once as a CUDA graph on the card and
replayed (`core/graphs.StepGraph`), and runs op by op on the CPU.
"""

from __future__ import annotations

import torch

from ..core import graphs
from ..core.dtypes import resolve_device

_DECAY, _EPS = 0.9, 1e-8


def _cluster_loss(Tx, Ty, Kx, Ky, mx, my) -> torch.Tensor:
    """|| tx Kx tx^T - ty Ky ty^T ||^2 with the columns of Tx, Ty masked
    (lowrank.py:31-36)."""
    tx, ty = Tx * mx[None, :], Ty * my[None, :]
    return torch.sum(torch.square(tx @ Kx @ tx.T - ty @ Ky @ ty.T))


def _cast_loss(a, F, Tx, Ty, Kx, Ky) -> torch.Tensor:
    """|| a Kx - Fc Ky Fc^T ||^2 with Fc = Tx^T F Ty (lowrank.py:60-63)."""
    Fc = Tx.T @ F @ Ty
    return torch.sum(torch.square(a * Kx - Fc @ Ky @ Fc.T))


def _rmsprop(params, grads, nus, lr: float) -> None:
    """One optax.rmsprop(lr) step in place: nu = 0.9 nu + 0.1 g^2, p -= lr
    g / sqrt(nu + 1e-8)."""
    with torch.no_grad():
        for p, g, nu in zip(params, grads, nus):
            nu.mul_(_DECAY).addcmul_(g, g, value=1 - _DECAY)
            p.sub_(lr * g * torch.rsqrt(nu + _EPS))


def _optimize(name: str, loss_fn, params, epochs: int, lr: float, device,
              generator=None) -> None:
    """`epochs` steps of loss_fn's gradient and RMSprop on `params`, in
    place: one step is jamie_tpu's `fori_loop` body (`torch.autograd.grad`
    and the update). On the card the step is captured once as a CUDA graph
    (its eager warm-up on the capture stream) and replayed, with
    `generator`, which loss_fn draws its masks from, registered so each
    replay draws new ones; elsewhere (`core/graphs.captures`) it runs op
    by op."""
    nus = [torch.zeros_like(p) for p in params]

    def step():
        loss = loss_fn(*params)
        _rmsprop(params, torch.autograd.grad(loss, params), nus, lr)
    graphs.steps_runner(name, step, device,
                        generators=() if generator is None else (generator,)
                        ).run(int(epochs))


def lowrank_corr(Kx, Ky, dim: int = 20, keep_prob: float = 0.35,
                 epochs: int = 10001, topk: int = 5, seed: int = 0,
                 device=None) -> torch.Tensor:
    """The (n, m) binarized correspondence on `device`: 1 at the `topk`
    largest entries of each row of Tx^T F Ty (lowrank.py:75-93). Both
    phases run captured on the card (`_optimize`)."""
    device = resolve_device(device)
    Kx = torch.as_tensor(Kx, dtype=torch.float32, device=device)
    Ky = torch.as_tensor(Ky, dtype=torch.float32, device=device)
    n, m = Kx.shape[0], Ky.shape[0]
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    print('Clustering')
    Tx = uniform(dim, n).requires_grad_()
    Ty = uniform(dim, m).requires_grad_()

    def cluster(Tx, Ty):
        mx = (uniform(n) > (1 - keep_prob)).float()
        my = (uniform(m) > (1 - keep_prob)).float()
        return _cluster_loss(Tx, Ty, Kx, Ky, mx, my)
    _optimize('lowrank_cluster', cluster, [Tx, Ty], epochs, 0.01, device,
              gen)
    Tx, Ty = Tx.detach(), Ty.detach()

    print('Casting')
    a = uniform(1).requires_grad_()
    F = uniform(dim, dim).requires_grad_()
    _optimize('lowrank_cast',
              lambda a, F: _cast_loss(a, F, Tx, Ty, Kx, Ky), [a, F],
              epochs, 0.1, device)
    with torch.no_grad():
        corr = Tx.T @ F @ Ty
        idx = torch.topk(corr, min(topk, m), dim=1).indices
        return torch.zeros_like(corr).scatter_(1, idx, 1.0)
