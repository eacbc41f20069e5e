"""Section timing / memory tracing.

Reference parity: `time_logger` (jamie/utilities.py:61-132) — named-section
wall-clock accumulation with a per-key mean report and optional tracemalloc
capture. `block=True` waits for queued CUDA work before stamping (kernel
launches return before the card finishes, so a bare host clock would time
the enqueue). `device_memory_stats` and `trace` are the device-side
counterparts of `jamie_tpu/core/timing.py:100-127`.
"""

from __future__ import annotations

import contextlib
import os
import tracemalloc
from time import perf_counter

import numpy as np
import torch


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
