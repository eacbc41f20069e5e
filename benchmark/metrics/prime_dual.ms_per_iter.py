"""Milliseconds per prime-dual iteration: the Correspondence phase over
the fit's iterations, so the solve's set-up and its graph capture are in
it."""

import records


def read(rec):
    return records.mean_of(
        rec, lambda f: 1000.0 * f['phases']['Correspondence'] / f['epoch_pd'])
