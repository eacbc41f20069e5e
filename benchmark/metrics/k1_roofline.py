"""K1's share of its roofline, in %: the bytes bound of one call at the
cell's (N0, N1) and the solver state dtype the fit ran with
(roofline/k1.py) over K1's mean device time per call in the profiled
fit."""

from roofline import k1
from tracing import kernel_time


def read(rec):
    t, peaks, fits = rec.get('trace'), rec.get('peaks'), rec.get('fits')
    if not t or not peaks or not fits:
        return None
    secs, calls = kernel_time(t, k1.KERNELS)
    if calls == 0 or secs <= 0:
        return None
    (m, _), (n, _) = rec['config']['shapes']
    bound = k1.bound_s(m, n, fits[0]['solver_state_dtype'], peaks)
    return 100.0 * bound / (secs / calls)
