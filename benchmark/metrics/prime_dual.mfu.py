"""The dense prime-dual solve's share of the card's bf16 dense peak, in %:
the iterations' GEMM FLOPs (roofline/prime_dual.py, from N0 and N1) over
the Correspondence phase's seconds."""

import records
from roofline import prime_dual


def read(rec):
    peaks = rec.get('peaks')
    if not peaks:
        return None
    (m, _), (n, _) = rec['config']['shapes']
    flops = prime_dual.flops_per_iteration(m, n)

    def one(f):
        secs = f['phases']['Correspondence']
        return 100.0 * flops * f['epoch_pd'] / secs / peaks['bf16_flops']
    return records.mean_of(rec, one)
