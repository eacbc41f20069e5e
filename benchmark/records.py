"""What a per-layer reader (`metrics/<name>.py`) reads. Its record holds:

- `fits`: one dict per timed fit of the traced run (the profiled fit
  left out when others ran): `seconds`, `phases` (the estimator's phase
  seconds), `mapping` (the mapping phase's sub-phase seconds), `transfer`
  (the residency's upload statistics), `epochs_run`, `steps_per_epoch`,
  `batch`, `epoch_pd`, `solve_shape` and `solver_state_dtype` (the
  (n0, n1) that K1 and the prime-dual solve ran at, and their state
  dtype, from the harness module's `solve`);
- `trace`: the profiled fit's `tracing.summarize` result, or None;
- `config`, `traffic`: the cell's files; `peaks`: the card's published
  peaks (`roofline/peaks.json`), or None for a card not listed."""

from __future__ import annotations

import statistics


def mean_of(rec: dict, fn):
    """The mean of fn(fit) over the record's fits, those that read None
    left out; None where none reads."""
    vals = [fn(f) for f in rec['fits']]
    vals = [v for v in vals if v is not None]
    return statistics.fmean(vals) if vals else None
