"""K3: pairwise (squared) euclidean distances, a CUDA C++ kernel.

Replaces `jamie_tpu/ops/ab_archive.py::pairwise_sq_euclidean_pallas`
(call :232, body `_pairwise_kernel` :196-210), which is the same function
as the production jnp Gram route `jamie_tpu/ops/distances.py:43-56`.

The kernel is `csrc/pairwise_sq_euclidean.cu`, built with nvcc for sm_90a
and bound with ctypes (`ops/_build.py`). What bounds it on an H100: 2*m*n*f
float32 FMAs on the CUDA cores (67 TFLOP/s without tensor cores), against
(m*f + n*f + m*n) * 4 bytes of traffic, so it is operation-bound at the
main path's shapes. The design keeps the x.y^T sum in registers and fuses
the norms, clamp, sqrt and zero diagonal into the store, so the (m, n)
Gram matrix is written once, as the distances. It is a plain register-tiled
SGEMM (64x64 tiles, 16-wide K-steps); TMA/wgmma and a TF32 or bf16 operand
route are later work.

`pairwise_euclidean` runs the kernel for CUDA tensors and its plain
PyTorch version `pairwise_euclidean_plain` for CPU tensors; any other input
raises. `pairwise_euclidean.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build


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


def _library():
    lib = _build.load('pairwise_sq_euclidean')
    fn = lib.pairwise_sq_euclidean_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
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
    xsq = (x * x).sum(1)
    ysq = xsq if self_dist else (y * y).sum(1)
    yy = x if self_dist else y
    kernel = _library()
    with torch.cuda.device(x.device):
        err = kernel(x.data_ptr(), yy.data_ptr(), xsq.data_ptr(),
                     ysq.data_ptr(), out.data_ptr(), m, n, f,
                     int(not squared), int(self_dist),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'pairwise_sq_euclidean kernel launch failed: '
                           f'cudaError {err}')
    pairwise_euclidean.launches += 1
    return out


pairwise_euclidean.launches = 0
