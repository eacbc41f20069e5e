"""The device's idle share of a fit's traced prefix, in %: 1 - busy /
wall over the profiled window, from the fit's call to the end of its
second training epoch (`tracing.TRAINED_EPOCHS`; the profiler cannot
stay on over the trainer's captured epochs, PERF.md). It covers the
distances, the solve, the PCA, the trainer's set-up and capture and two
epochs, and leaves out the rest of training. Busy: the union of the
window's kernel, memcpy and memset intervals."""


def read(rec):
    t = rec.get('trace')
    if not t or t['window_s'] <= 0 or t['device_events'] == 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
