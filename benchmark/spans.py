"""The program's own spans of a traced run's timed fits, for the
per-layer readers that read them (`jamie_tpu_torch/core/timing.py`).

The program keeps the root span of each of the process's last fits,
oldest first (`timing.recent_fits()`). A record's fits are the window's
last fits (the profiled first one left out when others ran), and the
check after the window fits nothing, so the last `len(rec['fits'])` roots
pair with `rec['fits']` in order. A pair whose phase spans, rounded as the
estimator rounds `phase_timings`, differ from that fit's `phases` is not
that fit, and the reading is None: a wrong pairing fails the run on the
card. A program without the recorder gives None too."""

from __future__ import annotations

import statistics


def fit_roots(rec: dict) -> list:
    """The root span of each of the record's fits, in order, or None for
    every fit where one pair fails (or there is no recorder)."""
    fits = rec.get('fits') or []
    try:
        from jamie_tpu_torch.core.timing import recent_fits
    except ImportError:
        return [None] * len(fits)
    roots = recent_fits()[-len(fits):] if fits else []
    if len(roots) != len(fits) or not all(
            {c.name: round(c.seconds, 3) for c in root.children}
            == fit['phases'] for root, fit in zip(roots, fits)):
        return [None] * len(fits)
    return roots


def mean_over_fits(rec: dict, fn):
    """The mean of fn(root span) over the record's fits; None where a root
    is missing or fn reads None for any fit."""
    vals = [None if root is None else fn(root) for root in fit_roots(rec)]
    if not vals or any(v is None for v in vals):
        return None
    return statistics.fmean(vals)


def seconds_of(root, name: str):
    """The summed seconds of the fit's spans named `name`; None where it
    has none."""
    found = root.find(name)
    return sum(s.seconds for s in found) if found else None


def device_ms_per(root, name: str, counter: str):
    """Device milliseconds of the fit's `name` spans per unit of their
    `counter` (replays, steps); None where no such span took device
    time."""
    found = [s for s in root.find(name)
             if s.device_s is not None and s.counters.get(counter)]
    if not found:
        return None
    return (1000.0 * sum(s.device_s for s in found)
            / sum(s.counters[counter] for s in found))
