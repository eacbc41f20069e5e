"""K3, pairwise squared euclidean distances (`csrc/pairwise_sq_euclidean.
cu`, TMA + wgmma, 3xTF32): the Gram x y^T as three TF32 products
(hi.hi + hi.lo + lo.hi) with the norms, clamp, sqrt and zero diagonal in
its epilogue. Operations: 3 x 2 m n f at the TF32 peak; bytes: each
input row read once (a self-distance reads x once) and the (m, n) float32
output written once. The bound is the larger of the two times. f is the
true feature width (the kernel pads it to a multiple of 4)."""

from __future__ import annotations

KERNELS = ('pairwise_tf32x3_kernel', 'splitk_reduce_kernel')
# The program's wrapper, whose launches the program counts
WRAPPER = 'pairwise_euclidean'


def ops(m: int, n: int, f: int) -> int:
    return 3 * 2 * m * n * f


def bytes_per_call(m: int, n: int, f: int, self_dist: bool) -> int:
    return 4 * (m * f + (0 if self_dist else n * f) + m * n)


def bound_s(m: int, n: int, f: int, self_dist: bool, peaks: dict) -> float:
    return max(ops(m, n, f) / peaks['tf32_flops'],
               bytes_per_call(m, n, f, self_dist) / peaks['hbm_bytes_per_s'])
