"""Seconds per fit of the landmark route's selection, both modalities'
picks (FPS on the JL sketch past the budget, its SpMM and CSR upload
included) and the gather of their rows: the program's
`landmark.selection` spans; None where the fit has none."""

import spans


def read(rec):
    return spans.mean_over_fits(
        rec, lambda root: spans.seconds_of(root, 'landmark.selection'))
