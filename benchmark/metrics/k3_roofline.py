"""K3's share of its roofline, in %: the summed bounds of the fit's K3
calls over K3's summed device time in the profiled fit. A fit that
launches K3 once per modality computes each modality's self distances
at its true width (roofline/k3.py); any other count has no known shapes,
and the metric is left out."""

from roofline import k3
from tracing import kernel_time


def read(rec):
    t, peaks, fits = rec.get('trace'), rec.get('peaks'), rec.get('fits')
    if not t or not peaks or not fits:
        return None
    secs, _ = kernel_time(t, k3.KERNELS)
    shapes = rec['config']['shapes']
    if secs <= 0 or fits[0]['launches'].get(k3.WRAPPER) != len(shapes):
        return None
    bound = sum(k3.bound_s(n, n, f, True, peaks) for n, f in shapes)
    return 100.0 * bound / secs
