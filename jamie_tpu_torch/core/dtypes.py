"""Dtype, device and matmul-precision policy.

Three rules the whole package follows:

- **Device.** Entry points run on the card. `resolve_device(None)` is
  CUDA device 0 and raises when no CUDA device is visible; the CPU is used
  only when a caller asks for it (`device='cpu'`, as the tests do).
- **No TF32.** A float32 matmul is exact float32: `pin_fp32_matmuls()`
  (run when the package is imported) turns TF32 off for cuBLAS and cuDNN
  rather than relying on PyTorch's defaults.
- **bf16 operands, f32 result.** `jamie_tpu` runs its 'default'-precision
  solver matmuls and `matmul_bf16` model layers as bf16 operands with an
  f32 result. `torch.matmul` on bf16 tensors returns bf16, which rounds the
  product, so `bf16_matmul` takes one of two routes, chosen once from what
  the installed PyTorch offers:
    * 'mm_out_dtype': `torch.mm(a, b, out_dtype=torch.float32)` on bf16
      operands, where the build has that kernel for CUDA tensors;
    * 'rounded_f32': an exact-f32 matmul of operands rounded to bf16. Each
      bf16 x bf16 product is exact in f32, so this gives the same numbers
      as an f32-accumulating bf16 GEMM, only slower. It is the route on
      the CPU and for tensors that need a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

# Whether this PyTorch build has the f32-result bf16 GEMM for CUDA tensors
# (dispatcher introspection, so the choice is made once, not by try/except).
MM_OUT_DTYPE_ON_CUDA = bool(torch._C._dispatch_has_kernel_for_dispatch_key(
    'aten::mm.dtype', 'CUDA'))


_DTYPES = {
    'float32': torch.float32,
    'bfloat16': torch.bfloat16,
    'float16': torch.float16,
    'float64': torch.float64,
}


def resolve_dtype(name):
    """A dtype name ('float32', 'bfloat16', ...) as its torch dtype; a
    dtype is returned as it is."""
    if isinstance(name, str):
        return _DTYPES[name]
    return name


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another device. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'jamie_tpu_torch runs on a CUDA device and none is visible; '
                "pass device='cpu' to run on the CPU explicitly.")
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)


def pin_fp32_matmuls() -> None:
    """Exact float32 matmuls and convolutions: TF32 off, explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bf16_matmul(a: torch.Tensor, b: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a @ b with both operands rounded to bf16 and an f32 result, written
    into `out` (f32) when it is given."""
    if (a.is_cuda and MM_OUT_DTYPE_ON_CUDA and a.dim() == 2 and b.dim() == 2
            and not (a.requires_grad or b.requires_grad)):
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                        out_dtype=torch.float32, out=out)
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float(), out=out)
