"""K1 + K2: the prime-dual iteration tail, one Triton kernel.

Replaces `jamie_tpu/ops/ab_archive.py::fused_pd_grad_update` (K1, call
:137, body `_pd_grad_update_kernel` :83-108) and `fused_pd_update` (K2,
call :180, body `_pd_update_kernel` :64-80). K2 is K1 without the gradient
assembly, so both are one `@triton.jit` kernel specialised by the
`HAS_GRAD` constexpr. Per (m, n) entry:

    grad = 4 mm4 - 4a KxFKy + rowvec + colvec          (K1 only)
    M1'  = 0.9 M1 + 0.1 grad;   M2' = 0.999 M2 + 0.001 grad^2
    step = (M1'/bias1) / (sqrt(M2'/bias2) + 1e-7)
    F'   = (1 - eps) F + eps max(F - step, 0)

What bounds it on an H100: memory. K1 moves 32 bytes per entry in float32
(five loads, three stores) for about 20 FLOPs, far below the ~20 FLOP/byte
where the card's float32 rate would matter. The design is one launch per
call and one flat pass over the m*n entries: all (m, n) operands are
contiguous, so a block of BLOCK consecutive entries loads and stores them
16 bytes a thread whatever n is (a row of 1047 floats does not start on a
16-byte boundary, which defeated the 2-D blocks of the first version).
Each entry's row (offs // n) and column index the O(m + n) vectors, and
the kernel folds the caller's row and column terms itself,

    rowvec = Mu + rho rowsum,   colvec = Lambda^T + rho (colsum + S^T - 2),

so the wrapper launches no other (m, n) pass on the card; every
intermediate (grad, the bias-corrected moments) stays in registers. `a`
is read from a 1-element device tensor, so the solver never syncs the
host to pass it.
The kernel writes F, M1 and M2 in place (each entry is read and written by
the same thread, read first). It reads Adam's two bias corrections
1 - pho^i from a (2,) float32 tensor on the device, so a captured solver
iteration (`solvers/prime_dual.py`) replays with each step's own
corrections: the wrapper computes them there from the solver's int32 step
counter (`bias_corrections`: two small launches, a pow and a subtraction,
the plain version's arithmetic, so the two agree to the bit on them), or
copies a host int step's float32 corrections there.
M1 and KxFKy load and store in their own dtype (f32, or bf16 for
state_dtype='bfloat16'); the arithmetic is always f32. BLOCK and
NUM_WARPS are fixed, chosen from the sizes chip_smoke.py sweeps on the card
(PERF.md).

`fused_pd_grad_update` / `fused_pd_update` launch the kernel for CUDA
tensors and run the plain PyTorch versions (`*_plain`, also in place) for
CPU tensors; any other input raises. Each wrapper's `.launches` counts its
kernel launches (`core/graphs.count_launch`: once per replay of a captured
call).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core.graphs import count_launch

PHO1, PHO2, DELTA = 0.9, 0.999, 1e-7
BLOCK, NUM_WARPS = 1024, 4

_kernel = None


def _triton_kernel():
    """Build the Triton kernel on first launch (triton is imported here, so
    the module imports where triton is absent)."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def pd_update_kernel(f_ptr, m1_ptr, m2_ptr, g_ptr, kxfky_ptr, mu_ptr,
                         lam_ptr, s_ptr, rowsum_ptr, colsum_ptr, a_ptr,
                         bias_ptr, total, n, eps, rho,
                         HAS_GRAD: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < total
        bias1 = tl.load(bias_ptr)
        bias2 = tl.load(bias_ptr + 1)
        if HAS_GRAD:
            row = offs // n
            col = offs - row * n
            a = tl.load(a_ptr)
            mm4 = tl.load(g_ptr + offs, mask=mask, other=0.0)
            kx = tl.load(kxfky_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            rowvec = (tl.load(mu_ptr + row, mask=mask, other=0.0)
                      + rho * tl.load(rowsum_ptr + row, mask=mask, other=0.0))
            colvec = (tl.load(lam_ptr + col, mask=mask, other=0.0)
                      + rho * (tl.load(colsum_ptr + col, mask=mask, other=0.0)
                               + (tl.load(s_ptr + col, mask=mask, other=0.0)
                                  - 2.0)))
            grad = 4.0 * mm4 - 4.0 * a * kx + rowvec + colvec
        else:
            grad = tl.load(g_ptr + offs, mask=mask, other=0.0)
        m1 = (0.9 * tl.load(m1_ptr + offs, mask=mask, other=0.0).to(tl.float32)
              + 0.1 * grad)
        m2 = 0.999 * tl.load(m2_ptr + offs, mask=mask, other=0.0) \
            + 0.001 * grad * grad
        step = tl.div_rn(tl.div_rn(m1, bias1),
                         tl.sqrt_rn(tl.div_rn(m2, bias2)) + 1e-7)
        f = tl.load(f_ptr + offs, mask=mask, other=0.0)
        f_new = (1.0 - eps) * f + eps * tl.maximum(f - step, 0.0)
        tl.store(f_ptr + offs, f_new, mask=mask)
        tl.store(m1_ptr + offs, m1.to(m1_ptr.dtype.element_ty), mask=mask)
        tl.store(m2_ptr + offs, m2, mask=mask)

    _kernel = (triton, pd_update_kernel)
    return _kernel


_BASES = {}


def bias_corrections(i: Union[int, torch.Tensor]):
    """Adam's 1 - pho^i for the 1-based timestep i, in float32. For a host
    int, two floats as the Pallas wrapper computes them; for a one-element
    step counter on a device, a (2,) float32 tensor computed there (with
    torch.pow, as jamie_tpu's XLA path computes them with jnp.power), so
    nothing is read back to the host. The bases' tensor is made once per
    device, by the first call there (a captured solver's eager warm-up)."""
    if isinstance(i, torch.Tensor):
        if i.device not in _BASES:
            _BASES[i.device] = torch.tensor((PHO1, PHO2), dtype=torch.float32,
                                            device=i.device)
        return 1.0 - torch.pow(_BASES[i.device], i.reshape(()))
    i_f = np.float32(i)
    return (float(np.float32(1.0) - np.power(np.float32(PHO1), i_f)),
            float(np.float32(1.0) - np.power(np.float32(PHO2), i_f)))


def _bias_operand(i, device):
    """The kernel's bias corrections, a (2,) float32 tensor on `device`:
    computed there from a step counter on the device, or copied there
    from a host int's."""
    if not isinstance(i, torch.Tensor):
        return torch.tensor(bias_corrections(i), dtype=torch.float32,
                            device=device)
    if i.numel() != 1 or i.dtype != torch.int32 or i.device != device:
        raise ValueError(f'the step must be one int32 value on {device}, '
                         f'got {tuple(i.shape)} {i.dtype} on {i.device}')
    return bias_corrections(i)


def _grad_vectors(Mu, Lambda, S, rowsum, colsum, rho):
    """The cheap O(m + n) terms, rowvec (m, 1) and colvec (1, n), as the
    Pallas wrapper pre-folds them (the kernel folds them itself)."""
    rowvec = Mu + rho * rowsum
    colvec = Lambda.T + rho * (colsum + (S - 2.0).T)
    return rowvec, colvec


def _adam_tail(F, M1, M2, grad, bias1, bias2, epsilon):
    """Adam, projection and the damped update, written into F, M1, M2."""
    m1 = PHO1 * M1.float() + (1 - PHO1) * grad
    m2 = PHO2 * M2 + (1 - PHO2) * grad * grad
    step = (m1 / bias1) / (torch.sqrt(m2 / bias2) + DELTA)
    F.copy_((1 - epsilon) * F + epsilon * torch.clamp(F - step, min=0.0))
    M1.copy_(m1)
    M2.copy_(m2)
    return F, M1, M2


def fused_pd_grad_update_plain(F, M1, M2, mm4, KxFKy, Mu, Lambda, S, rowsum,
                               colsum, a, i, epsilon: float, rho: float):
    """Plain PyTorch version of K1: updates F, M1, M2 in place and
    returns them."""
    bias1, bias2 = bias_corrections(i)
    rowvec, colvec = _grad_vectors(Mu, Lambda, S, rowsum, colsum, rho)
    grad = 4.0 * mm4 - 4.0 * a * KxFKy.float() + rowvec + colvec
    return _adam_tail(F, M1, M2, grad, bias1, bias2, epsilon)


def fused_pd_update_plain(F, M1, M2, grad, i, epsilon: float):
    """Plain PyTorch version of K2: updates F, M1, M2 in place and
    returns them."""
    bias1, bias2 = bias_corrections(i)
    return _adam_tail(F, M1, M2, grad, bias1, bias2, epsilon)


def _check_state(F, M1, M2, others) -> None:
    dev = F.device
    for name, t, dtypes in (('F', F, (torch.float32,)),
                            ('M1', M1, (torch.float32, torch.bfloat16)),
                            ('M2', M2, (torch.float32,))) + others:
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, expected {dev}')
        if t.dtype not in dtypes:
            raise TypeError(f'{name} has dtype {t.dtype}, expected one of '
                            f'{dtypes}')
        if t.shape != F.shape or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous with shape '
                             f'{tuple(F.shape)}, got {tuple(t.shape)}')


def _launch(F, M1, M2, g, kxfky, vectors, rho, a, i, epsilon, has_grad,
            block=BLOCK, num_warps=NUM_WARPS):
    """One kernel launch, updating F, M1, M2 in place; `vectors` = (Mu,
    Lambda, S, rowsum, colsum) as flat views. block and num_warps are
    parameters only for the sweep."""
    triton, kernel = _triton_kernel()
    m, n = F.shape
    bias = _bias_operand(i, F.device)
    with torch.cuda.device(F.device):
        kernel[(triton.cdiv(m * n, block),)](
            F, M1, M2, g, kxfky, *vectors, a, bias, m * n, n, float(epsilon),
            float(rho), HAS_GRAD=has_grad, BLOCK=block, num_warps=num_warps)
    return F, M1, M2


def _route(F) -> str:
    if F.device.type == 'cuda' and F.numel() >= 2 ** 31:
        raise ValueError('prime-dual tail: m * n must fit in int32')
    if F.device.type in ('cpu', 'cuda'):
        return F.device.type
    raise ValueError(f'prime-dual tail runs on CUDA or CPU tensors, got '
                     f'{F.device}')


def fused_pd_grad_update(F, M1, M2, mm4, KxFKy, Mu, Lambda, S, rowsum,
                         colsum, a, i, epsilon: float, rho: float):
    """K1: gradient assembly + Adam + projection + damped F update.

    F, M2, mm4: (m, n) f32; M1, KxFKy: (m, n) f32 or bf16; Mu, rowsum
    (m, 1); Lambda, S (n, 1); colsum (1, n); a: 0-d or 1-element f32
    tensor; i: the 1-based Adam timestep, a host int or a one-element
    int32 counter on F's device. Writes F', M1', M2' into F, M1, M2 and
    returns them."""
    if _route(F) == 'cpu':
        return fused_pd_grad_update_plain(F, M1, M2, mm4, KxFKy, Mu, Lambda,
                                          S, rowsum, colsum, a, i, epsilon,
                                          rho)
    _check_state(F, M1, M2, (
        ('mm4', mm4, (torch.float32,)),
        ('KxFKy', KxFKy, (torch.float32, torch.bfloat16))))
    if a.numel() != 1 or a.dtype != torch.float32 or a.device != F.device:
        raise ValueError('a must be a 1-element float32 tensor on F.device')
    m, n = F.shape
    vectors = []
    for name, v, size in (('Mu', Mu, m), ('Lambda', Lambda, n), ('S', S, n),
                          ('rowsum', rowsum, m), ('colsum', colsum, n)):
        if (v.numel() != size or v.dtype != torch.float32
                or v.device != F.device):
            raise ValueError(f'{name} must hold {size} float32 values on '
                             f'{F.device}, got {tuple(v.shape)} {v.dtype}')
        vectors.append(v.reshape(-1))   # a view of the solver's vectors
    out = _launch(F, M1, M2, mm4, KxFKy, vectors, rho, a, i, epsilon, True)
    count_launch(fused_pd_grad_update)
    return out


def fused_pd_update(F, M1, M2, grad, i, epsilon: float):
    """K2: Adam + projection + damped F update from a precomputed grad,
    in place as K1."""
    if _route(F) == 'cpu':
        return fused_pd_update_plain(F, M1, M2, grad, i, epsilon)
    _check_state(F, M1, M2, (('grad', grad, (torch.float32,)),))
    # the unused K1 operands get grad as a placeholder pointer
    out = _launch(F, M1, M2, grad, grad, (grad,) * 5, 0.0, grad, i, epsilon,
                  False)
    count_launch(fused_pd_update)
    return out


fused_pd_grad_update.launches = 0
fused_pd_update.launches = 0
