"""The coupled VAE block's tail, one Triton kernel forward and one backward.

A `_Block` of `models/coupled_vae.py` is Linear + BatchNorm (flax's, in
train mode: batch statistics) + LeakyReLU(0.01) + dropout. Its tail, all
that follows the Linear's matmul, is here as an autograd Function whose
forward and backward are each one launch:

    u = z + b                      (z = x W^T, b the Linear's bias)
    mean = sum(u) / B,  sq = sum(u^2) / B,  var = max(sq - mean^2, 0)
    rstd = 1 / sqrt(var + eps),  a = rstd * scale
    running_mean = m running_mean + (1 - m) mean   (the same for var)
    y = leaky((u - mean) a + beta), then y / keep or 0 by the keep-mask

It replaces no TPU kernel: `jamie_tpu` leaves this tail to XLA, which
fuses it into its step. Composed from PyTorch ops it is ~43 kernels a
block (forward and backward), 8 blocks a step, each on a (512, <= 1024)
batch, where the launch and the gap between kernels cost more than the
work. What bounds the kernels on an H100 is memory: a few FLOPs per byte.
At the trainer's shapes they move 2-4 MB and are bound by latency, so the
design is the fewest launches and the fewest dependent passes:

- one program per block of BLOCK_F columns walks all B rows twice, in
  tiles of BLOCK_B rows (one tile per pass at B = 512); pass 1 sums u and
  u^2 in float32, pass 2 writes y. The second pass reads its tile again,
  from L2. No atomics: every column's sums are one program's, in one
  order, so a captured step equals its eager twin bit for bit;
- the forward updates the running statistics in place and saves only
  (mean, rstd, gate), a (3, f) float32 tensor, for the backward, which
  recomputes u, the normalised value and the LeakyReLU's sign from z;
- the backward takes sum(g) and sum(g xhat) per column in pass 1 (the
  BatchNorm's dbeta and dscale), writes dz in pass 2 and the column sum
  of dz, the Linear bias's gradient, so no separate reduction runs.

Semantics are flax's BatchNorm, with the composed ops' autograd: the
biased variance clipped at 0, whose branch of the gradient is cut where
sq - mean^2 < 0 (`gate`), as torch.clamp's backward cuts it; statistics
and normalisation in float32 whatever the input's dtype (flax's
`force_float32_reductions`), the output cast back. For a bfloat16 input
the kernels round where the composed bf16 ops round: the bias add, the
cast of the normalised value, LeakyReLU's slope, the dropout scale, and
the same points of the backward.

`block_tail_forward` / `block_tail_backward` launch the kernels for CUDA
tensors and run the plain PyTorch versions (`*_plain`, the same
arithmetic in the same order, in float64 for a float64 input) for CPU
tensors; anything else raises. Each wrapper's `.launches` counts its
launches (`core/graphs.count_launch`: once per replay of a captured
call). Block sizes follow f and B, the shapes the caller has; nothing is
autotuned.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.graphs import count_launch

SLOPE = 0.01          # LeakyReLU's negative slope
TILE = 4096           # elements of one (BLOCK_B, BLOCK_F) tile

_kernels = None


def _triton_kernels():
    """Build both Triton kernels on first launch (triton is imported here,
    so the module imports where triton is absent)."""
    global _kernels
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    # Every value is float32 in registers; `.to(dt).to(tl.float32)` rounds
    # it to the tensors' dtype where the composed ops round (a no-op for
    # float32). LeakyReLU's slope is 0.01 (SLOPE).
    @triton.jit
    def block_tail_fwd(z_ptr, lb_ptr, scale_ptr, beta_ptr, rm_ptr, rv_ptr,
                       mask_ptr, y_ptr, stats_ptr, B, f, nf, inv_keep,
                       momentum, one_minus, eps, HAS_MASK: tl.constexpr,
                       BLOCK_B: tl.constexpr, BLOCK_F: tl.constexpr):
        dt = y_ptr.dtype.element_ty
        cols = tl.program_id(0) * BLOCK_F + tl.arange(0, BLOCK_F)
        cm = cols < f
        lb = tl.load(lb_ptr + cols, mask=cm, other=0.0).to(dt).to(tl.float32)
        s1 = tl.zeros([BLOCK_F], tl.float32)
        s2 = tl.zeros([BLOCK_F], tl.float32)
        for r0 in range(0, B, BLOCK_B):
            rows = r0 + tl.arange(0, BLOCK_B)
            m = (rows < B)[:, None] & cm[None, :]
            off = rows[:, None] * f + cols[None, :]
            u = (tl.load(z_ptr + off, mask=m, other=0.0).to(tl.float32)
                 + lb[None, :]).to(dt).to(tl.float32)
            u = tl.where(m, u, 0.0)
            s1 += tl.sum(u, axis=0)
            s2 += tl.sum(u * u, axis=0)
        mean = tl.div_rn(s1, nf)
        vraw = tl.div_rn(s2, nf) - mean * mean
        var = tl.maximum(vraw, 0.0, propagate_nan=tl.PropagateNan.ALL)
        rstd = tl.div_rn(1.0, tl.sqrt_rn(var + eps))
        a = rstd * tl.load(scale_ptr + cols, mask=cm, other=0.0)
        beta = tl.load(beta_ptr + cols, mask=cm, other=0.0)
        rm = tl.load(rm_ptr + cols, mask=cm, other=0.0)
        rv = tl.load(rv_ptr + cols, mask=cm, other=0.0)
        tl.store(rm_ptr + cols, rm * momentum + one_minus * mean, mask=cm)
        tl.store(rv_ptr + cols, rv * momentum + one_minus * var, mask=cm)
        tl.store(stats_ptr + cols, mean, mask=cm)
        tl.store(stats_ptr + f + cols, rstd, mask=cm)
        tl.store(stats_ptr + 2 * f + cols, tl.where(vraw >= 0.0, 1.0, 0.0),
                 mask=cm)
        for r0 in range(0, B, BLOCK_B):
            rows = r0 + tl.arange(0, BLOCK_B)
            m = (rows < B)[:, None] & cm[None, :]
            off = rows[:, None] * f + cols[None, :]
            u = (tl.load(z_ptr + off, mask=m, other=0.0).to(tl.float32)
                 + lb[None, :]).to(dt).to(tl.float32)
            t = ((u - mean[None, :]) * a[None, :]
                 + beta[None, :]).to(dt).to(tl.float32)
            y = tl.where(t > 0.0, t, (t * 0.01).to(dt).to(tl.float32))
            if HAS_MASK:
                keep = tl.load(mask_ptr + off, mask=m, other=0) != 0
                y = tl.where(keep, (y * inv_keep).to(dt).to(tl.float32), 0.0)
            tl.store(y_ptr + off, y.to(dt), mask=m)

    @triton.jit
    def block_tail_bwd(dy_ptr, z_ptr, lb_ptr, scale_ptr, beta_ptr,
                       stats_ptr, mask_ptr, dz_ptr, grads_ptr, B, f, nf,
                       inv_keep, HAS_MASK: tl.constexpr,
                       BLOCK_B: tl.constexpr, BLOCK_F: tl.constexpr):
        dt = dz_ptr.dtype.element_ty
        cols = tl.program_id(0) * BLOCK_F + tl.arange(0, BLOCK_F)
        cm = cols < f
        lb = tl.load(lb_ptr + cols, mask=cm, other=0.0).to(dt).to(tl.float32)
        mean = tl.load(stats_ptr + cols, mask=cm, other=0.0)
        rstd = tl.load(stats_ptr + f + cols, mask=cm, other=0.0)
        gate = tl.load(stats_ptr + 2 * f + cols, mask=cm, other=0.0)
        a = rstd * tl.load(scale_ptr + cols, mask=cm, other=0.0)
        beta = tl.load(beta_ptr + cols, mask=cm, other=0.0)
        # pass 1: sum(g) and sum(g xhat), g the gradient at the
        # BatchNorm's output (through the dropout, then LeakyReLU, whose
        # sign is read from the recomputed output)
        sg = tl.zeros([BLOCK_F], tl.float32)
        sgx = tl.zeros([BLOCK_F], tl.float32)
        for r0 in range(0, B, BLOCK_B):
            rows = r0 + tl.arange(0, BLOCK_B)
            m = (rows < B)[:, None] & cm[None, :]
            off = rows[:, None] * f + cols[None, :]
            u = (tl.load(z_ptr + off, mask=m, other=0.0).to(tl.float32)
                 + lb[None, :]).to(dt).to(tl.float32)
            xhat = (u - mean[None, :]) * rstd[None, :]
            t = ((u - mean[None, :]) * a[None, :]
                 + beta[None, :]).to(dt).to(tl.float32)
            g = tl.load(dy_ptr + off, mask=m, other=0.0).to(tl.float32)
            if HAS_MASK:
                keep = tl.load(mask_ptr + off, mask=m, other=0) != 0
                g = tl.where(keep, (g * inv_keep).to(dt).to(tl.float32), 0.0)
            g = tl.where(t > 0.0, g, (g * 0.01).to(dt).to(tl.float32))
            g = tl.where(m, g, 0.0)
            sg += tl.sum(g, axis=0)
            sgx += tl.sum(g * xhat, axis=0)
        mg = tl.div_rn(sg, nf)
        mgx = tl.div_rn(sgx, nf) * gate
        # pass 2: dz, and its column sum (the Linear bias's gradient)
        sdz = tl.zeros([BLOCK_F], tl.float32)
        for r0 in range(0, B, BLOCK_B):
            rows = r0 + tl.arange(0, BLOCK_B)
            m = (rows < B)[:, None] & cm[None, :]
            off = rows[:, None] * f + cols[None, :]
            u = (tl.load(z_ptr + off, mask=m, other=0.0).to(tl.float32)
                 + lb[None, :]).to(dt).to(tl.float32)
            xhat = (u - mean[None, :]) * rstd[None, :]
            t = ((u - mean[None, :]) * a[None, :]
                 + beta[None, :]).to(dt).to(tl.float32)
            g = tl.load(dy_ptr + off, mask=m, other=0.0).to(tl.float32)
            if HAS_MASK:
                keep = tl.load(mask_ptr + off, mask=m, other=0) != 0
                g = tl.where(keep, (g * inv_keep).to(dt).to(tl.float32), 0.0)
            g = tl.where(t > 0.0, g, (g * 0.01).to(dt).to(tl.float32))
            du = (a[None, :] * (g - mg[None, :] - xhat * mgx[None, :])
                  ).to(dt).to(tl.float32)
            du = tl.where(m, du, 0.0)
            tl.store(dz_ptr + off, du.to(dt), mask=m)
            sdz += tl.sum(du, axis=0)
        tl.store(grads_ptr + cols, sdz.to(dt).to(tl.float32), mask=cm)
        tl.store(grads_ptr + f + cols, sgx, mask=cm)
        tl.store(grads_ptr + 2 * f + cols, sg, mask=cm)

    _kernels = (triton, block_tail_fwd, block_tail_bwd)
    return _kernels


def block_sizes(B: int, f: int) -> Tuple[int, int, int]:
    """(BLOCK_B, BLOCK_F, num_warps) for a (B, f) input: 16 columns a
    program from f = 256 up (64 programs at f = 1024), else 8, so narrow
    blocks still spread over a few programs; a tile of at most TILE
    elements, all B rows in one tile up to B = TILE / BLOCK_F."""
    block_f = 16 if f >= 256 else 8
    block_b = min(max(16, 1 << max(B - 1, 0).bit_length()), TILE // block_f)
    return block_b, block_f, 8 if block_b * block_f >= 2048 else 4


def _inv_keep(keep: float) -> float:
    """1 / keep in float32, as PyTorch's division of a CUDA tensor by a
    scalar multiplies by it."""
    return float(np.float32(1.0) / np.float32(keep))


def _rnd(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype).to(v.dtype)


def _u_plain(z, lin_bias):
    """The Linear's output with its bias, in the statistics' dtype, rounded
    to z's dtype as the composed ops' add rounds it."""
    sd = torch.promote_types(z.dtype, torch.float32)
    return _rnd(z.to(sd) + lin_bias.to(z.dtype).to(sd), z.dtype)


def _grad_in_plain(dy, mask, t, keep, dtype):
    g = dy.to(t.dtype)
    if mask is not None:
        g = torch.where(mask, _rnd(g * _inv_keep(keep), dtype),
                        torch.zeros_like(g))
    return torch.where(t > 0, g, _rnd(g * SLOPE, dtype))


def block_tail_forward_plain(z, lin_bias, scale, beta, running_mean,
                             running_var, mask, keep: float,
                             momentum: float, eps: float):
    """Plain PyTorch version of the forward kernel: returns (y, stats),
    stats the (3, f) (mean, rstd, gate) the backward takes, and updates
    running_mean and running_var in place."""
    B = z.shape[0]
    u = _u_plain(z, lin_bias)
    mean = u.sum(0) / B
    vraw = (u * u).sum(0) / B - mean * mean
    var = torch.clamp(vraw, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    a = rstd * scale.to(u.dtype)
    with torch.no_grad():
        running_mean.copy_(running_mean * momentum + (1 - momentum) * mean)
        running_var.copy_(running_var * momentum + (1 - momentum) * var)
    t = _rnd((u - mean) * a + beta.to(u.dtype), z.dtype)
    y = torch.where(t > 0, t, _rnd(t * SLOPE, z.dtype))
    if mask is not None:
        y = torch.where(mask, _rnd(y * _inv_keep(keep), z.dtype),
                        torch.zeros_like(y))
    stats = torch.stack([mean, rstd, (vraw >= 0).to(u.dtype)])
    return y.to(z.dtype), stats


def block_tail_backward_plain(dy, z, lin_bias, scale, beta, stats, mask,
                              keep: float):
    """Plain PyTorch version of the backward kernel: (dz, the Linear
    bias's gradient, dscale, dbeta) from the output's gradient dy."""
    B = z.shape[0]
    u = _u_plain(z, lin_bias)
    mean, rstd, gate = stats.to(u.dtype)
    a = rstd * scale.to(u.dtype)
    t = _rnd((u - mean) * a + beta.to(u.dtype), z.dtype)
    g = _grad_in_plain(dy, mask, t, keep, z.dtype)
    xhat = (u - mean) * rstd
    sg, sgx = g.sum(0), (g * xhat).sum(0)
    du = _rnd(a * (g - sg / B - xhat * (sgx / B * gate)), z.dtype)
    dlb = _rnd(du.sum(0), z.dtype)
    pd = scale.dtype
    return du.to(z.dtype), dlb.to(pd), sgx.to(pd), sg.to(pd)


def _check(z, mask, named) -> None:
    """The wrapper's checks on CUDA inputs: z a contiguous (B, f) float32
    or bfloat16 matrix, each vector a contiguous float32 (f,) on its
    device, the mask a contiguous bool (B, f) or None."""
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the block tail takes float32 or bfloat16, got '
                        f'{z.dtype}')
    if z.dim() != 2 or not z.is_contiguous() or z.numel() == 0:
        raise ValueError(f'z must be a contiguous, non-empty (B, f) matrix, '
                         f'got {tuple(z.shape)}')
    if z.numel() >= 2 ** 31:
        raise ValueError('block tail: B * f must fit in int32')
    f = z.shape[1]
    for name, v in named:
        if (v.device != z.device or v.dtype != torch.float32
                or v.shape != (f,) or not v.is_contiguous()):
            raise ValueError(f'{name} must be a contiguous float32 ({f},) on '
                             f'{z.device}, got {tuple(v.shape)} {v.dtype} '
                             f'on {v.device}')
    if mask is not None and (mask.device != z.device
                             or mask.dtype != torch.bool
                             or mask.shape != z.shape
                             or not mask.is_contiguous()):
        raise ValueError(f'the mask must be a contiguous bool '
                         f'{tuple(z.shape)} on {z.device}')


def _route(z) -> str:
    if z.device.type in ('cpu', 'cuda'):
        return z.device.type
    raise ValueError(f'the block tail runs on CUDA or CPU tensors, got '
                     f'{z.device}')


def block_tail_forward(z, lin_bias, scale, beta, running_mean, running_var,
                       mask: Optional[torch.Tensor], keep: float,
                       momentum: float, eps: float):
    """The forward kernel: (y, stats) from z (B, f) and the Linear's bias,
    the BatchNorm's scale, bias and running statistics (updated in place),
    and the keep-mask (None without dropout) with its keep probability."""
    if _route(z) == 'cpu':
        return block_tail_forward_plain(z, lin_bias, scale, beta,
                                        running_mean, running_var, mask,
                                        keep, momentum, eps)
    _check(z, mask, (('lin_bias', lin_bias), ('scale', scale),
                     ('beta', beta), ('running_mean', running_mean),
                     ('running_var', running_var)))
    triton, fwd, _ = _triton_kernels()
    B, f = z.shape
    block_b, block_f, warps = block_sizes(B, f)
    y = torch.empty_like(z)
    stats = torch.empty((3, f), dtype=torch.float32, device=z.device)
    m = z if mask is None else mask.view(torch.uint8)
    with torch.cuda.device(z.device):
        fwd[(triton.cdiv(f, block_f),)](
            z, lin_bias, scale, beta, running_mean, running_var, m, y, stats,
            B, f, float(B), _inv_keep(keep) if mask is not None else 1.0,
            float(momentum), float(1 - momentum), float(eps),
            HAS_MASK=mask is not None, BLOCK_B=block_b, BLOCK_F=block_f,
            num_warps=warps)
    count_launch(block_tail_forward)
    return y, stats


def block_tail_backward(dy, z, lin_bias, scale, beta, stats, mask,
                        keep: float):
    """The backward kernel: (dz, the Linear bias's gradient, dscale,
    dbeta) from the output's gradient dy and what the forward saved."""
    if _route(z) == 'cpu':
        return block_tail_backward_plain(dy, z, lin_bias, scale, beta,
                                         stats, mask, keep)
    _check(z, mask, (('lin_bias', lin_bias), ('scale', scale),
                     ('beta', beta)))
    dy = dy.contiguous()
    if dy.shape != z.shape or dy.dtype != z.dtype or dy.device != z.device:
        raise ValueError(f'dy must match z, got {tuple(dy.shape)} '
                         f'{dy.dtype} on {dy.device}')
    triton, _, bwd = _triton_kernels()
    B, f = z.shape
    block_b, block_f, warps = block_sizes(B, f)
    dz = torch.empty_like(z)
    grads = torch.empty((3, f), dtype=torch.float32, device=z.device)
    m = z if mask is None else mask.view(torch.uint8)
    with torch.cuda.device(z.device):
        bwd[(triton.cdiv(f, block_f),)](
            dy, z, lin_bias, scale, beta, stats, m, dz, grads, B, f,
            float(B), _inv_keep(keep) if mask is not None else 1.0,
            HAS_MASK=mask is not None, BLOCK_B=block_b, BLOCK_F=block_f,
            num_warps=warps)
    count_launch(block_tail_backward)
    return dz, grads[0], grads[1], grads[2]


block_tail_forward.launches = 0
block_tail_backward.launches = 0


class BlockTail(torch.autograd.Function):
    """The tail as one autograd node: forward and backward one launch
    each on the card (the plain versions on the CPU). Saves z, the three
    parameter vectors, (mean, rstd, gate) and the mask."""

    @staticmethod
    def forward(ctx, z, lin_bias, scale, beta, running_mean, running_var,
                mask, keep, momentum, eps):
        y, stats = block_tail_forward(z, lin_bias, scale, beta, running_mean,
                                      running_var, mask, keep, momentum, eps)
        ctx.save_for_backward(z, lin_bias, scale, beta, stats, mask)
        ctx.keep = keep
        return y

    @staticmethod
    def backward(ctx, dy):
        z, lin_bias, scale, beta, stats, mask = ctx.saved_tensors
        dz, dlb, dscale, dbeta = block_tail_backward(
            dy, z, lin_bias, scale, beta, stats, mask, ctx.keep)
        return dz, dlb, dscale, dbeta, None, None, None, None, None, None


def block_tail(z, lin_bias, bn, mask: Optional[torch.Tensor],
               keep: float) -> torch.Tensor:
    """The tail of a `_Block` in train mode after its Linear's matmul z
    (B, f): the Linear's bias `lin_bias`, then the `FlaxBatchNorm` `bn`
    with batch statistics (its running statistics updated in place),
    LeakyReLU(0.01) and, given a keep-mask, the dropout."""
    return BlockTail.apply(z, lin_bias, bn.weight, bn.bias, bn.running_mean,
                           bn.running_var, mask, keep, bn.momentum, bn.eps)
