"""Seconds per fit in the builds of the CSR arms' device copies (the
`DeviceCSR` uploads, their bf16 rounding at scale): the program's
`residency.csr` spans; None where the fit built none."""

import spans


def read(rec):
    return spans.mean_over_fits(
        rec, lambda root: spans.seconds_of(root, 'residency.csr'))
