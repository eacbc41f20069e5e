"""Milliseconds per prime-dual iteration of the landmark solve alone, its
set-up and capture included: the program's `landmark.solve` span seconds
over its `iterations` counter, per fit. None where the fit has no such
span or counter (`prime_dual.ms_per_iter` divides the whole
Correspondence phase, which on this route holds the selection, the
landmark distances and the weights too)."""

import spans


def _ms(root):
    found = [s for s in root.find('landmark.solve')
             if s.counters.get('iterations')]
    if not found:
        return None
    return (1000.0 * sum(s.seconds for s in found)
            / sum(s.counters['iterations'] for s in found))


def read(rec):
    return spans.mean_over_fits(rec, _ms)
