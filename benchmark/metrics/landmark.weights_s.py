"""Seconds per fit of the landmark route's cell-to-landmark weights and
F's factors (SpMM Gram blocks of every cell against the landmark rows,
the kNN-Gaussian weights, U = A_x F_L): the program's `landmark.weights`
spans; None where the fit has none."""

import spans


def read(rec):
    return spans.mean_over_fits(
        rec, lambda root: spans.seconds_of(root, 'landmark.weights'))
