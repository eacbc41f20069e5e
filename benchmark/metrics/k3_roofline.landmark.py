"""K3's share of its roofline on the landmark route, in %: the summed
bounds of the K3 calls that the profiled fit's `landmark.distances` spans
make (each modality's landmark rows against themselves, L x L x its
features, where that modality's `distances.base` span took the `k3`
route; roofline/k3.py) over K3's summed device time in that fit. None
where the fit has no such span or counters, or where K3 launched another
number of times than those calls."""

import spans
from roofline import k3
from tracing import kernel_time


def _shapes(root):
    """[(L, features)] of the fit's K3 calls, or None."""
    out = []
    for d in root.find('landmark.distances'):
        L, feats = d.counters.get('L'), d.counters.get('features')
        bases = d.find('distances.base')
        if not L or not feats or len(bases) != len(L):
            return None
        out += [(n, f) for n, f, b in zip(L, feats, bases)
                if b.counters.get('route') == 'k3']
    return out or None


def read(rec):
    t, peaks, fits = rec.get('trace'), rec.get('peaks'), rec.get('fits')
    if not t or not peaks or not fits:
        return None
    roots = spans.fit_roots(rec)
    if not roots or roots[0] is None:
        return None
    shapes = _shapes(roots[0])
    secs, _ = kernel_time(t, k3.KERNELS)
    if (not shapes or secs <= 0
            or fits[0].get('launches', {}).get(k3.WRAPPER) != len(shapes)):
        return None
    bound = sum(k3.bound_s(n, n, f, True, peaks) for n, f in shapes)
    return 100.0 * bound / secs
