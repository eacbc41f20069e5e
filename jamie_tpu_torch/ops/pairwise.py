"""K3: pairwise (squared) euclidean distances, a CUDA C++ kernel on
Hopper's tensor cores.

Replaces `jamie_tpu/ops/ab_archive.py::pairwise_sq_euclidean_pallas`
(call :232, body `_pairwise_kernel` :196-210), which is the same function
as the production jnp Gram route `jamie_tpu/ops/distances.py:43-56`.

The kernel is `csrc/pairwise_sq_euclidean.cu`, built with nvcc for sm_90a
and bound with ctypes (`core/_build.py`): TMA loads into a 3-stage ring,
wgmma TF32 products with a 3xTF32 split (float32-accurate, not bit-exact),
and the norms, clamp, sqrt and zero diagonal fused into the store. What
bounds it on an H100: 3 * 2*m*n*f TF32 operations at 495 TFLOP/s against
(m*f + n*f + m*n) * 4 bytes, so operations at the main path's shapes.

This module prepares what the kernel cannot: the row norms (in torch, as
the Pallas wrapper computes them outside its kernel), a zero-padded copy
of an operand whose feature width is not a multiple of 4 or whose base is
not 16-byte aligned (TMA needs both), and the split-K factor
(`launch_plan`) with its (splits, m, n) workspace.

`pairwise_euclidean` runs the kernel for CUDA tensors and its plain
PyTorch version `pairwise_euclidean_plain` for CPU tensors; any other input
raises. `pairwise_euclidean.launches` counts kernel launches (through
`core/graphs.count_launch`, so a call captured into a CUDA graph counts
once per replay). A call may be captured: the tensor maps hold the
operands' addresses, and inside a capture the padded copies, the norms,
the workspace and the output come from the graph's own memory, at the same
addresses on every replay.
`pairwise_euclidean_autograd` is the same function with an analytic
backward (`_PairwiseEuclidean`), so a loss on the distances can be
differentiated through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core import _build
from ..core.graphs import count_launch

TILE = 128           # output rows and columns per block (BM, BN in the source)
K_STEP = 32          # features per pipeline stage (BK in the source)
MAX_SPLITS = 16
MIN_STEPS_PER_SPLIT = 4

_ERRORS = {-1: 'no driver entry point for cuTensorMapEncodeTiled',
           -2: 'a split-K factor that leaves a feature slice empty',
           -3: 'a device index past the library\'s MAX_DEVICES'}


def pairwise_euclidean_plain(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                             squared: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the Gram route with the same epilogue."""
    self_dist = y is None
    y = x if y is None else y
    xsq = (x * x).sum(1)
    ysq = xsq if self_dist else (y * y).sum(1)
    d = torch.clamp(xsq[:, None] + ysq[None, :] - 2.0 * (x @ y.T), min=0.0)
    if not squared:
        d = torch.sqrt(d)
    if self_dist:
        d.fill_diagonal_(0.0)
    return d


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(m: int, n: int, f: int, num_sms: int) -> Tuple[int, int]:
    """(padded feature width, split-K factor) for an (m, n, f) call.

    The width is rounded up to a multiple of 4 (TMA's 16-byte row stride).
    Where the 128x128 output tiles fill at least one wave of the card's
    SMs the kernel runs whole (splits = 1). Below that, the feature axis is
    cut into `splits` slices of at least MIN_STEPS_PER_SPLIT stages each,
    none empty, choosing the factor that minimises the waves per slice plus
    a small charge per slice for the partials' traffic."""
    fp = 4 * _cdiv(max(f, 1), 4)
    tiles = _cdiv(m, TILE) * _cdiv(n, TILE)
    ksteps = _cdiv(fp, K_STEP)
    best, best_cost = 1, 1.01
    if tiles < num_sms:
        for s in range(2, min(MAX_SPLITS, ksteps // MIN_STEPS_PER_SPLIT) + 1):
            if (s - 1) * _cdiv(ksteps, s) >= ksteps:
                continue   # the last slice would be empty
            cost = _cdiv(tiles * s, num_sms) / s + 0.01 * s
            if cost < best_cost:
                best, best_cost = s, cost
    return fp, best


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _needs_copy(t: torch.Tensor, fp: int) -> bool:
    return t.shape[1] != fp or t.data_ptr() % 16 != 0


def _tma_operand(t: torch.Tensor, fp: int) -> torch.Tensor:
    """t itself, or a 16-byte aligned copy zero-padded to fp features (zero
    features add nothing to the sums)."""
    if not _needs_copy(t, fp):
        return t
    out = t.new_zeros((t.shape[0], fp))
    out[:, :t.shape[1]] = t
    return out


def device_kernels_per_call(x: torch.Tensor,
                            y: Optional[torch.Tensor] = None) -> int:
    """Device kernels one `pairwise_euclidean(x, y)` call on the card issues:
    per distinct operand two for its norms (square, row sum) and two for a
    padded copy where one is needed (fill, copy); the main kernel; and the
    split-K pass where the plan splits."""
    operands = [x] if y is None else [x, y]
    m, f = x.shape
    n = m if y is None else y.shape[0]
    fp, splits = launch_plan(m, n, f, _num_sms(x.device.index or 0))
    return (sum(2 + 2 * _needs_copy(t, fp) for t in operands) + 1
            + int(splits > 1))


def _library():
    lib = _build.load('pairwise_sq_euclidean')
    fn = lib.pairwise_sq_euclidean_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != torch.float32:
        raise TypeError(f'{name} must be float32, got {t.dtype}')
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f'{name} must be a contiguous 2-D tensor')


def pairwise_euclidean(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                       squared: bool = True) -> torch.Tensor:
    """(m, n) distances between the rows of x (m, f) and y (n, f); y=None is
    self-distance, whose diagonal is exactly 0. squared=False takes the
    sqrt (the 'euclidean' metric)."""
    if x.device.type == 'cpu':
        return pairwise_euclidean_plain(x, y, squared)
    if x.device.type != 'cuda':
        raise ValueError(f'pairwise_euclidean runs on CUDA or CPU tensors, '
                         f'got {x.device}')
    self_dist = y is None
    _check(x, 'x', x.device)
    if not self_dist:
        _check(y, 'y', x.device)
        if y.shape[1] != x.shape[1]:
            raise ValueError(f'feature widths differ: {x.shape} vs {y.shape}')
    m, f = x.shape
    n = m if self_dist else y.shape[0]
    if max(m, n, f) >= 2 ** 31:
        raise ValueError('pairwise_euclidean: dimensions must fit in int32')
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    fp, splits = launch_plan(m, n, f, _num_sms(x.device.index or 0))
    xsq = (x * x).sum(1)
    ysq = xsq if self_dist else (y * y).sum(1)
    xk = _tma_operand(x, fp)
    yk = xk if self_dist else _tma_operand(y, fp)
    ws = (torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
          if splits > 1 else out)
    kernel = _library()
    with torch.cuda.device(x.device):
        err = kernel(xk.data_ptr(), yk.data_ptr(), xsq.data_ptr(),
                     ysq.data_ptr(), out.data_ptr(), ws.data_ptr(), m, n, fp,
                     splits, int(not squared), int(self_dist),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = (_ERRORS.get(err) or
                (f'cuTensorMapEncodeTiled returned CUresult {-1000 - err}'
                 if err <= -1000 else f'cudaError {err}'))
        raise RuntimeError(f'pairwise_sq_euclidean kernel launch failed: '
                           f'{what}')
    count_launch(pairwise_euclidean)
    return out


pairwise_euclidean.launches = 0


class _PairwiseEuclidean(torch.autograd.Function):
    """`pairwise_euclidean` forward (K3 on the card, the plain version on
    the CPU) with an analytic backward in torch matmuls.

    For squared distances D and upstream G, D_ij = |x_i - y_j|^2 gives
    dx = 2 (diag(G 1) x - G y) and dy = 2 (diag(G^T 1) y - G^T x); a
    self-distance takes both roles, so G becomes G + G^T. The sqrt route
    passes G / (2 d) through where d > 0. Entries with d = 0 (the clamp, the
    zeroed diagonal, coincident rows) get a zero gradient: the sqrt has no
    derivative there, and autograd through sqrt(max(d2, 0)) gives NaN."""

    @staticmethod
    def forward(ctx, x, y, squared):
        d = pairwise_euclidean(x, y, squared=squared)
        ctx.save_for_backward(x, y, d)
        ctx.squared = squared
        return d

    @staticmethod
    def backward(ctx, grad):
        x, y, d = ctx.saved_tensors
        live = d > 0
        if ctx.squared:
            g = torch.where(live, grad, 0.0)
        else:
            g = torch.where(live, grad / (2.0 * torch.where(live, d, 1.0)),
                            0.0)
        if y is None:
            g = g + g.T
            return 2.0 * (g.sum(1, keepdim=True) * x - g @ x), None, None
        dx = 2.0 * (g.sum(1, keepdim=True) * x - g @ y)
        dy = 2.0 * (g.sum(0)[:, None] * y - g.T @ x)
        return dx, dy, None


def pairwise_euclidean_autograd(x: torch.Tensor,
                                y: Optional[torch.Tensor] = None,
                                squared: bool = True) -> torch.Tensor:
    """`pairwise_euclidean` that autograd can differentiate (see
    `_PairwiseEuclidean`); the operands are made contiguous first."""
    return _PairwiseEuclidean.apply(
        x.contiguous(), None if y is None else y.contiguous(), squared)
