"""Section timing, memory tracing and the program's spans.

Reference parity: `time_logger` (jamie/utilities.py:61-132) — named-section
wall-clock accumulation with a per-key mean report and optional tracemalloc
capture. `block=True` waits for queued CUDA work before stamping (kernel
launches return before the card finishes, so a bare host clock would time
the enqueue). `device_memory_stats` and `trace` are the device-side
counterparts of `jamie_tpu/core/timing.py:100-127`.

The spans: the program's own record of where a fit spends its time.
`span(name)` is a context manager that times the work it encloses with
`time.perf_counter_ns()` and links it to the span that encloses it, so each
`JAMIE().fit_transform` leaves one tree, rooted at its `fit` span (the
estimator's phases, and under them the distances, the residency's build,
the solver's set-up, captures and replays, the preprocessing and the
trainer's capture, replays and waits). A span carries:

- its name, parent, children, and the id of the fit it belongs to;
- counters the code attaches to it (`Span.set`, `Span.add`, `note`),
  among them the route a call site took (`route`: a name, or a list of
  them, one a modality) and the steps the device loops inside it ran
  (`loops`: steps by '{loop}/{route}', `count_steps`; the trainer's epochs
  that ran are the loop 'epochs'), which `routes` tallies over a tree;
- for a phase (`sync=True`) and a fit's root, on the card,
  `torch.cuda.memory_allocated()` at its close, a host-side read (~22 us
  on the H100's host; a read at every span's close would take most of the
  recorder's budget of 1 ms a fit);
- for a span opened with `device=True`, the device seconds from the start
  of its first graph replays to the end of its last (`device_begin`, from
  `core/graphs.StepGraph.run` and the trainer's dispatch): one CUDA event
  pair, recorded outside any stream capture and read once a `sync=True`
  span, an estimator phase that waits for the card anyway, has closed.

While a `torch.profiler` is active each span also opens a profiler range
named `jamie.<name>` on the host's timeline, so the spans sit in the
profiler's trace beside the device's work (`trace` writes it) and name
its idle gaps; with none active the cost is one flag check. Spans stay in
memory: the estimator keeps its fit's root as `JAMIE.trace`, and
`recent_fits()` returns the roots of the last `FITS_KEPT` fits of the
process. Recording is always on, a few dozen spans a fit and none per
step, and it allocates no device memory and adds no synchronize of its
own.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import tracemalloc
from time import perf_counter, perf_counter_ns
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch.autograd import profiler as _profiler


class TimeLogger:
    def __init__(
        self,
        discard_first_sample: bool = False,
        record: bool = True,
        verbose: bool = False,
        memory_usage: bool = False,
        block: bool = False,
    ):
        self.discard_first_sample = discard_first_sample
        self.record = record
        self.verbose = verbose
        self.memory_usage = memory_usage
        self.block = block

        self.history: dict = {}
        self.history_mem: dict = {}
        if memory_usage:
            tracemalloc.start()
        self.start_time = perf_counter()

    def _sync(self):
        # Only a process that has touched the card has queued work to wait
        # for; CPU-only runs have nothing to drain.
        if self.block and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def log(self, name: str = ''):
        if not (self.verbose or self.record):
            return
        self._sync()
        end_time = perf_counter()
        elapsed = end_time - self.start_time
        if self.record:
            self.history.setdefault(name, []).append(elapsed)
        if self.verbose:
            print(f'{name}: {elapsed}')
        if self.memory_usage:
            if self.record:
                self.history_mem.setdefault(name, []).append(
                    tracemalloc.get_traced_memory())
            tracemalloc.stop()
            tracemalloc.start()
        self.start_time = perf_counter()

    def aggregate(self):
        """Print mean time per section and the running total (ref format)."""
        running_total = 0.0
        for k, v in self.history.items():
            vals = np.array(v)
            if self.discard_first_sample and len(vals) > 1:
                vals = vals[1:]
            mean = float(np.mean(vals))
            running_total += mean
            print(f'{k}: {mean}')
            if self.memory_usage and k in self.history_mem:
                stored = sum(m[0] for m in self.history_mem[k])
                peak = max(m[1] for m in self.history_mem[k])
                print(f'{k} Memory: Stored {stored} - Peak {peak}')
        print(f'Total: {running_total}')
        return running_total

    def totals(self) -> dict:
        return {k: float(np.sum(v)) for k, v in self.history.items()}

    def stop(self):
        if self.memory_usage:
            tracemalloc.stop()


def device_memory_stats(device=None) -> dict:
    """Device memory of one CUDA device under jamie_tpu's keys
    (`bytes_in_use`, `peak_bytes_in_use`, `bytes_limit`), from
    `torch.cuda.memory_stats` and `torch.cuda.mem_get_info`. Only the keys
    the backend reports: {} for the CPU, as jamie_tpu's CPU backend gives."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type != 'cuda':
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {'bytes_in_use': stats.get('allocated_bytes.all.current'),
           'peak_bytes_in_use': stats.get('allocated_bytes.all.peak'),
           'bytes_limit': torch.cuda.mem_get_info(device)[1]}
    return {k: int(v) for k, v in out.items() if v is not None}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work with torch.profiler (CPU and, when a card
    is visible, CUDA activity) and write a Chrome trace,
    `{log_dir}/trace.json`, for chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


# The roots of the last FITS_KEPT fits of the process, oldest first
FITS_KEPT = 64
_recent: collections.deque = collections.deque(maxlen=FITS_KEPT)
_fit_ids = itertools.count(1)
_open = threading.local()       # .stack: this thread's open spans
# spans whose device events are recorded and not read yet
_pending: List['Span'] = []

# A span's profiler range: a RecordFunction of the operators' scope, an
# event of the host's timeline ('cpu_op'). A `record_function` range
# (scope 'user_annotation') is mirrored onto the device's timeline too, as
# an annotation from its first kernel to its last, which a reading of the
# device's busy time would count as work.
profiler_range = getattr(torch._C._profiler, '_RecordFunctionFast',
                         _profiler.record_function)


def _allocated() -> int:
    """`torch.cuda.memory_allocated()` of the current device, read from the
    allocator's nested statistics: `memory_allocated` flattens and sorts
    all of them first, ~0.15 ms on the H100's host."""
    stats = torch._C._cuda_memoryStats(torch.cuda.current_device())
    return int(stats['allocated_bytes']['all']['current'])


def _stack() -> list:
    stack = getattr(_open, 'stack', None)
    if stack is None:
        stack = _open.stack = []
    return stack


class Span:
    """One timed piece of the program and its counters; a context manager
    (`with span('name') as sp:`). `sync=True` waits for the card's queued
    work before the span closes (the estimator's phases, as
    `TimeLogger(block=True)` did), then reads the device events of the
    spans that recorded them and, on the card, the allocated bytes;
    `device=True` lets the graph replays inside the span record its device
    time; `fit=True` starts a new fit: the span takes a new fit id, reads
    the allocated bytes at its close and is kept in `recent_fits()`."""

    __slots__ = ('name', 'parent', 'children', 'fit_id', 'counters',
                 'start_ns', 'end_ns', 'memory_allocated', '_device_s',
                 '_sync', '_device', '_fit', '_events', '_range')

    def __init__(self, name: str, sync: bool = False, device: bool = False,
                 fit: bool = False, **counters):
        self.name = name
        self.parent: Optional[Span] = None
        self.children: List[Span] = []
        self.fit_id: Optional[int] = None
        self.counters: dict = counters
        self.start_ns = self.end_ns = None
        self.memory_allocated: Optional[int] = None
        self._device_s: Optional[float] = None
        self._sync, self._device, self._fit = sync, device, fit
        self._events = self._range = None

    def __enter__(self) -> 'Span':
        stack = _stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            self.parent = parent
            parent.children.append(self)
            self.fit_id = parent.fit_id
        if self._fit:
            self.fit_id = next(_fit_ids)
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._range = profiler_range('jamie.' + self.name)
            self._range.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        cuda = torch.cuda.is_initialized()
        if self._sync and cuda:
            torch.cuda.synchronize()
        self.end_ns = perf_counter_ns()
        if self._range is not None:
            try:
                self._range.__exit__(None, None, None)
            except RuntimeError:
                pass    # the profiler that opened the range has stopped
            self._range = None
        if cuda and (self._sync or self._fit):
            self.memory_allocated = _allocated()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._sync and cuda:
            _read_events()
        if self._fit:
            _recent.append(self)
        return False

    # ---------------------------------------------------------- counters
    def set(self, **counters) -> None:
        self.counters.update(counters)

    def add(self, key: str, n=1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    # ------------------------------------------------------- device time
    def device_end(self) -> None:
        """Mark the end of the span's device work so far: after the graph
        replays that `device_begin` returned this span for."""
        if self._events is None or torch.cuda.is_current_stream_capturing():
            return
        if len(self._events) == 1:
            self._events.append(torch.cuda.Event(enable_timing=True))
        self._events[1].record()

    def _read(self) -> bool:
        """Read the device seconds once both events have run."""
        ev = self._events
        if ev is None or len(ev) < 2 or not ev[1].query():
            return False
        self._device_s = ev[0].elapsed_time(ev[1]) * 1e-3
        self._events = None
        return True

    @property
    def device_s(self) -> Optional[float]:
        """Device seconds from the first replay's start to the last one's
        end; None where the span timed none (or they have not run yet)."""
        if self._events is not None and self._read():
            _pending.remove(self)
        return self._device_s

    # ----------------------------------------------------------- reading
    @property
    def seconds(self) -> Optional[float]:
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def self_seconds(self) -> Optional[float]:
        """The span's seconds that none of its children covers."""
        if self.end_ns is None:
            return None
        return self.seconds - sum(c.seconds or 0.0 for c in self.children)

    def walk(self) -> Iterator['Span']:
        """This span and every span under it, in the order they opened."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List['Span']:
        """The spans under this one (itself included) named `name`."""
        return [s for s in self.walk() if s.name == name]

    def child(self, name: str) -> Optional['Span']:
        """The first direct child named `name`."""
        return next((c for c in self.children if c.name == name), None)

    def __repr__(self) -> str:
        return (f'Span({self.name!r}, seconds={self.seconds}, '
                f'counters={self.counters})')


# `with span(name) as sp:`
span = Span


def current() -> Optional[Span]:
    """The innermost open span of this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def note(**counters) -> None:
    """Set counters on the innermost open span, if any (a route taken)."""
    sp = current()
    if sp is not None:
        sp.counters.update(counters)


def count_steps(loop: str, route: str, n: int) -> None:
    """n steps of the device loop `loop` on `route`, added to the `loops`
    counter of the innermost open span, if any."""
    sp = current()
    if sp is not None and n > 0:
        loops = sp.counters.setdefault('loops', {})
        key = f'{loop}/{route}'
        loops[key] = loops.get(key, 0) + n


def routes(root: Span) -> collections.Counter:
    """The routes taken under `root`: each `route` counter once (each entry
    of a list of them), and the steps of each device loop by
    '{loop}/{route}' (the `loops` counters)."""
    tally: collections.Counter = collections.Counter()
    for sp in root.walk():
        route = sp.counters.get('route')
        if route is not None:
            tally.update([route] if isinstance(route, str) else route)
        tally.update(sp.counters.get('loops', {}))
    return tally


def device_begin() -> Optional[Span]:
    """Before graph replays: the innermost open span when it was opened
    with `device=True` and nothing is being captured, its start event
    recorded before its first replays; else None. Call `device_end()` on
    it after the replays."""
    sp = current()
    if (sp is None or not sp._device or not torch.cuda.is_initialized()
            or torch.cuda.is_current_stream_capturing()):
        return None
    if sp._events is None and sp._device_s is None:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        sp._events = [start]
        _pending.append(sp)
    return sp


def _read_events() -> None:
    """Read the device events that have run (after a synchronize)."""
    _pending[:] = [s for s in _pending if not s._read()]


def recent_fits() -> List[Span]:
    """The root spans of the process's last `FITS_KEPT` fits, oldest
    first."""
    return list(_recent)


def print_phases(spans: Sequence[Span]) -> float:
    """The phases' report in `TimeLogger.aggregate`'s lines: "name:
    seconds" for each span, "name Memory: Stored s - Peak p" where the span
    holds tracemalloc's (current, peak) as its `host_memory` counter, and
    "Total:"; returns the total."""
    running_total = 0.0
    for sp in spans:
        seconds = sp.seconds
        running_total += seconds
        print(f'{sp.name}: {seconds}')
        mem = sp.counters.get('host_memory')
        if mem is not None:
            print(f'{sp.name} Memory: Stored {mem[0]} - Peak {mem[1]}')
    print(f'Total: {running_total}')
    return running_total
