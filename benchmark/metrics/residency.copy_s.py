"""Host seconds per fit in the bf16 residency's uploads, the pageable
`.to(device)` copies of its builds: the `copy_s` counters of the
program's `residency.build` spans; None where the fit built none."""

import spans


def _copy_s(root):
    found = root.find('residency.build')
    return sum(s.counters['copy_s'] for s in found) if found else None


def read(rec):
    return spans.mean_over_fits(rec, _copy_s)
