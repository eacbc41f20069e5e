"""Device milliseconds per training step: the device time from the first
epoch replay's start to the last one's end (one CUDA event pair, the
program's `trainer.replay` span) over the steps replayed; the capture of
the three epoch graphs is left out."""

import spans


def read(rec):
    return spans.mean_over_fits(
        rec, lambda root: spans.device_ms_per(root, 'trainer.replay',
                                              'steps'))
