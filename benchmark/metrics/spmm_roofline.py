"""The SpMMs' share of their roofline, in %: the summed bounds of the
fit's SpMM calls (their sizes from the program's `spmm` counters, the
same in every fit; roofline/spmm.py) over the SpMM kernels' summed
device time in the profiled fit. None where the fit counts no SpMM or
the trace holds no SpMM kernel."""

import spans
from roofline import spmm
from tracing import kernel_time


def _calls(root):
    return [c for s in root.walk() for c in s.counters.get('spmm', ())]


def read(rec):
    t, peaks = rec.get('trace'), rec.get('peaks')
    if not t or not peaks:
        return None
    roots = spans.fit_roots(rec)
    if not roots or roots[0] is None:
        return None
    calls = _calls(roots[0])
    secs, _ = kernel_time(t, spmm.KERNELS)
    if not calls or secs <= 0:
        return None
    bound = sum(spmm.bound_s(*c, peaks) for c in calls)
    return 100.0 * bound / secs
