"""K1, the prime-dual iteration tail (`ops/pd_update.py`, Triton): one
pass over the (m, n) state per iteration. Its bound is bytes: five
(m, n) loads (F, M1, M2, mm4, KxFKy) and three stores (F, M1, M2), M1 and
KxFKy in the state dtype, the others float32, and the O(m + n) vectors
(Mu, Lambda, S, rowsum, colsum) read once."""

from __future__ import annotations

KERNELS = ('pd_update_kernel',)

_STATE_BYTES = {'float32': 4, 'bfloat16': 2}


def bytes_per_call(m: int, n: int, state_dtype: str) -> int:
    s = _STATE_BYTES[state_dtype]
    per_entry = (4 + s + 4 + 4 + s) + (4 + s + 4)
    return m * n * per_entry + 4 * (2 * m + 3 * n)


def bound_s(m: int, n: int, state_dtype: str, peaks: dict) -> float:
    return bytes_per_call(m, n, state_dtype) / peaks['hbm_bytes_per_s']
