"""Device milliseconds per replayed prime-dual iteration: the device time
from the first replay of the captured iteration to the end of the last
(one CUDA event pair, the program's `prime_dual.replay` span) over its
replays; the set-up and the capture, with its warm-up iteration, are
left out."""

import spans


def read(rec):
    return spans.mean_over_fits(
        rec, lambda root: spans.device_ms_per(root, 'prime_dual.replay',
                                              'replays'))
