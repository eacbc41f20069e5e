"""K1's share of its roofline, in %: the bytes bound of one call at the
shape the profiled fit's solve ran at and in its solver state dtype
(`solve_shape`, `solver_state_dtype`: (N0, N1) on the dense route, the
landmark subproblem's on the landmark route; roofline/k1.py) over K1's
mean device time per call in the profiled fit."""

from roofline import k1
from tracing import kernel_time


def read(rec):
    t, peaks, fits = rec.get('trace'), rec.get('peaks'), rec.get('fits')
    if not t or not peaks or not fits:
        return None
    secs, calls = kernel_time(t, k1.KERNELS)
    if calls == 0 or secs <= 0:
        return None
    m, n = fits[0]['solve_shape']
    bound = k1.bound_s(m, n, fits[0]['solver_state_dtype'], peaks)
    return 100.0 * bound / (secs / calls)
