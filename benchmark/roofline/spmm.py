"""A CSR times dense product (SpMM), whatever implements it: each output
entry of each nonzero's row takes one multiply-add, 2 nnz k operations
(float32, on the FP32 peak); its bytes are each nonzero's value and
column index (4 + 4) read once, the dense operand (its rows x k float32)
read once and the output (its rows x k float32) written once. The bound
is the larger of the two times (a one-column product, an SpMV, is bound
by its bytes). A call's sizes are the program's `spmm` counters, [nnz, k,
operand rows, output rows] (`core/residency`)."""

from __future__ import annotations

# Device kernels of cuSPARSE's CSR products, by name: the SpMM
# (csrmm_alg2), the SpMV it takes for one column (csrmv_v3), and their
# row partition and beta scaling (H100, CUDA 12.8)
KERNELS = ('cusparse::csrmm', 'cusparse::csrmv', 'csr_partition_kernel',
           'scalar_multiply_kernel')


def ops(nnz: int, k: int) -> int:
    return 2 * nnz * k


def bytes_per_call(nnz: int, k: int, operand_rows: int,
                   out_rows: int) -> int:
    return 8 * nnz + 4 * k * (operand_rows + out_rows)


def bound_s(nnz: int, k: int, operand_rows: int, out_rows: int,
            peaks: dict) -> float:
    return max(ops(nnz, k) / peaks['fp32_flops'],
               bytes_per_call(nnz, k, operand_rows, out_rows)
               / peaks['hbm_bytes_per_s'])
