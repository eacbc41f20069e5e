"""The traced run's reduction: a fit under `torch.profiler`, reduced to
the device's busy time, kernel time by name and the longest idle gaps.

The profiler records CPU and CUDA activity over the traced window: from
the fit's call to the end of its `TRAINED_EPOCHS`-th training epoch (the
fit's end if it trains less), a `record_function` range named `WINDOW`.
On the H100 the process died in `cudaGraphLaunch` under the profiler
after some hundreds of replays of the trainer's captured epochs (graphs
under a conditional node; PERF.md), so the profiler stops there, after a
synchronize, and the rest of the fit runs untraced. Busy time is the
union of the device's kernel, memcpy and memset intervals inside the
window. The events are read from the profiler's raw results, without
building its per-event Python tree.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

WINDOW = 'benchmark.fit'
TRAINED_EPOCHS = 2
TOP = 10


class TracedFit:
    """Profile the enclosed fit until the end of its `epochs`-th epoch of
    captured training (or its end): `with TracedFit() as t: fit()`, then
    `summarize(t.prof)`."""

    def __init__(self, epochs: int = TRAINED_EPOCHS):
        self.epochs, self.seen = epochs, 0
        self.prof = self._range = None
        self.running = False

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        from jamie_tpu_torch.core import graphs
        self._graphs = graphs
        self._replay = replay = graphs.StepGraph.replay
        traced = self

        def counted(graph, k):
            replay(graph, k)
            # the trainer's epochs: graphs under the conditional node
            if graph.cond is not None and graph.name == 'epoch_end':
                traced.seen += k
                if traced.seen >= traced.epochs:
                    traced.stop()
        graphs.StepGraph.replay = counted
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.running = True
        self._range = record_function(WINDOW)
        self._range.__enter__()
        return self

    def stop(self):
        if not self.running:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.running = False

    def __exit__(self, *exc):
        try:
            self.stop()
        finally:
            self._graphs.StepGraph.replay = self._replay
        return False


def _merge(starts: np.ndarray, ends: np.ndarray):
    """Disjoint (start, end) segments of the union of the intervals."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind='stable')
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], e[last]


def summarize(prof) -> dict:
    """busy_s, window_s, the device events' count, kernel seconds and
    calls by name, the top device ops and the longest idle gaps, each gap
    named by the innermost host event around its middle."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    w0 = w1 = None
    host = []
    dev_s, dev_e, by_name = [], [], defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.name() == WINDOW and ev.device_type() == DeviceType.CUDA:
            continue    # the range's own mark on the device's timeline
        if ev.device_type() == DeviceType.CUDA:
            s = ev.start_ns()
            d = ev.duration_ns()
            dev_s.append(s)
            dev_e.append(s + d)
            acc = by_name[ev.name()]
            acc[0] += d * 1e-9
            acc[1] += 1
        else:
            name = ev.name()
            s = ev.start_ns()
            if name == WINDOW:
                w0, w1 = s, s + ev.duration_ns()
            else:
                host.append((s, s + ev.duration_ns(), name))
    if w0 is None:
        raise RuntimeError(f'the trace holds no {WINDOW!r} range')
    starts = np.clip(np.asarray(dev_s, np.int64), w0, w1)
    ends = np.clip(np.asarray(dev_e, np.int64), w0, w1)
    seg_s, seg_e = _merge(starts, ends)
    busy_ns = int(np.sum(seg_e - seg_s)) if len(seg_s) else 0
    gap_s = np.concatenate([[w0], seg_e]) if len(seg_s) else np.array([w0])
    gap_e = np.concatenate([seg_s, [w1]]) if len(seg_s) else np.array([w1])
    order = np.argsort(gap_s - gap_e)[:TOP]
    gaps = []
    for k in order:
        a, b = int(gap_s[k]), int(gap_e[k])
        if b <= a:
            continue
        mid = (a + b) // 2
        around = [h for h in host if h[0] <= mid <= h[1]]
        name = (min(around, key=lambda h: h[1] - h[0])[2] if around
                else 'host (no recorded op)')
        gaps.append([name, (b - a) * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        'busy_s': busy_ns * 1e-9,
        'window_s': (w1 - w0) * 1e-9,
        'device_events': len(dev_s),
        'kernels': {k: list(v) for k, v in by_name.items()},
        'breakdown': {'device_ops': [[k, v[0]] for k, v in ops[:TOP]],
                      'idle_gaps': gaps},
    }


def kernel_time(summary: dict, names) -> tuple:
    """(seconds, calls) of the device kernels whose names contain one of
    `names`."""
    secs, calls = 0.0, 0
    for k, (s, c) in summary['kernels'].items():
        if any(n in k for n in names):
            secs += s
            calls += c
    return secs, calls
