"""One iteration of the dense prime-dual correspondence solver on an
(m, n) state: four GEMMs, inner = F^T (F Ky) (2 m n^2), mm4 = (F Ky) inner
(2 m n^2), F Ky (2 m n^2) and Kx (F Ky) (2 m^2 n), 8 N^3 for m = n. The
rest of the iteration is O(m n) and left out. The operands are bf16 (the
solver's default precision), so the peak is the dense bf16 rate."""

from __future__ import annotations


def flops_per_iteration(m: int, n: int) -> int:
    return 6 * m * n * n + 2 * m * m * n
