"""The prime-dual solve's share of the card's bf16 dense peak, in %: the
iterations' GEMM FLOPs at the shape each fit's solve ran at
(`solve_shape`; roofline/prime_dual.py) over the Correspondence phase's
seconds."""

import records
from roofline import prime_dual


def read(rec):
    peaks = rec.get('peaks')
    if not peaks:
        return None

    def one(f):
        flops = prime_dual.flops_per_iteration(*f['solve_shape'])
        secs = f['phases']['Correspondence']
        return 100.0 * flops * f['epoch_pd'] / secs / peaks['bf16_flops']
    return records.mean_of(rec, one)
