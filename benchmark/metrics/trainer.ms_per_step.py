"""Milliseconds per training step: the Training sub-phase over the epochs
run times the steps per epoch."""

import records


def read(rec):
    return records.mean_of(
        rec, lambda f: 1000.0 * f['mapping']['Training']
        / (f['epochs_run'] * f['steps_per_epoch']))
