"""Seconds per fit of CUDA graph captures, each with its eager warm-up
step, its allocator release and its instantiation: the program's
`graphs.capture` spans (the prime-dual iteration's and the trainer's
three epoch parts)."""

import spans


def read(rec):
    return spans.mean_over_fits(
        rec, lambda root: spans.seconds_of(root, 'graphs.capture'))
