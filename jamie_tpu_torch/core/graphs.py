"""CUDA graphs for the port's device loops (`csrc/graph_cond.cu`).

jamie_tpu compiles each of its loops into one device program (a
`lax.fori_loop` or `lax.scan`). The port's counterpart is a step captured
once as a CUDA graph on static buffers and replayed from the host:

- `StepGraph` captures a step callable (after one eager warm-up step on
  the capture stream) and replays it `k` times, with the `torch.Generator`s
  the step draws from registered; `steps_runner` picks it where
  `captures(device)`: on a CUDA device, outside `plain_loops()` (the one,
  thread-local switch to the plain route the graphs are held to), and the
  same step op by op elsewhere, so both routes run one function. The
  solver loops, UMAP's, MMD-MA's and the trainer's epochs all capture
  through it, on one device and on a device mesh, where the step's NCCL
  collectives are captured with it (`core/mesh.py`). A loop's steps are
  recorded by route on the span open around it (`timing.count_steps`).
- `count_launch` counts a kernel wrapper's launches, once per replay for a
  launch inside a captured step.
- `add_conditional` puts an IF conditional node into a capture, as the
  trainer's epochs need (`StepGraph(cond=...)`, `train/trainer.py`): the
  counterpart of jamie_tpu's `lax.cond` over post-stop epochs
  (jamie_tpu/train/trainer.py:499-530). PyTorch's `CUDAGraph` does not
  capture conditional nodes itself, so it adds one, with a copy of an
  already captured graph as its body, to the graph that a stream is
  capturing.
- `node_counts` reports a kept graph's nodes and kernel nodes.
- `end_failed_capture` ends the generators' capture that a failed capture
  leaves open.

The library is built with nvcc on first use (`core/_build.py`); nothing
here runs on the CPU but `count_launch` and the eager route.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from . import _build
from . import mesh as cm
from . import timing

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load('graph_cond')
        lib.cond_add.argtypes = [ctypes.c_void_p] * 4
        lib.cond_add.restype = ctypes.c_int
        lib.graph_nodes.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_ulonglong),
                                    ctypes.POINTER(ctypes.c_ulonglong)]
        lib.graph_nodes.restype = ctypes.c_int
        _lib = lib
    return _lib


def add_conditional(stream: torch.cuda.Stream, body: torch.cuda.CUDAGraph,
                    stopped: torch.Tensor, live: torch.Tensor) -> None:
    """On `stream`, which must be capturing: a kernel that writes
    live = not stopped (two 0-d bool tensors on the card) and sets the
    condition from it, then an IF node whose body is a copy of `body`
    (captured with keep_graph=True and kept alive as long as the graph
    being captured). Raises on any CUDA error."""
    for t in (stopped, live):
        if not (t.is_cuda and t.dtype == torch.bool and t.numel() == 1):
            raise ValueError('stopped and live must be one-element bool '
                             'tensors on the card')
    rc = _load().cond_add(stream.cuda_stream, body.raw_cuda_graph(),
                          stopped.data_ptr(), live.data_ptr())
    if rc != 0:
        raise RuntimeError(f'adding the conditional node failed: '
                           f'{"the stream is not capturing" if rc == -1 else f"CUDA error {rc}"}')


def node_counts(graph: torch.cuda.CUDAGraph) -> Tuple[int, int]:
    """(nodes, kernel nodes) of a graph captured with keep_graph=True,
    child graphs included."""
    nodes, kernels = ctypes.c_ulonglong(), ctypes.c_ulonglong()
    rc = _load().graph_nodes(graph.raw_cuda_graph(), ctypes.byref(nodes),
                             ctypes.byref(kernels))
    if rc != 0:
        raise RuntimeError(f'counting graph nodes failed: CUDA error {rc}')
    return int(nodes.value), int(kernels.value)


# The kernel launches that a capture in progress has recorded, by wrapper
# (None while nothing is captured).
_capturing: Optional[Dict[Callable, int]] = None

_plain = threading.local()       # .depth: this thread's open plain_loops()


@contextlib.contextmanager
def plain_loops() -> Iterator[None]:
    """Within it, in this thread, every device loop and the trainer's
    epochs run op by op, on the card too: the plain version that the
    captured route is held to."""
    _plain.depth = getattr(_plain, 'depth', 0) + 1
    try:
        yield
    finally:
        _plain.depth -= 1


def captures(device) -> bool:
    """Whether a device loop on `device` runs as a captured CUDA graph: on
    a CUDA device, outside `plain_loops()`."""
    return (torch.device(device).type == 'cuda'
            and not getattr(_plain, 'depth', 0))


def count_launch(fn: Callable) -> None:
    """One launch of the kernel wrapper `fn`, added to `fn.launches` now,
    or, inside a `StepGraph` capture, once for each replay of the graph."""
    if _capturing is None:
        fn.launches += 1
    else:
        _capturing[fn] = _capturing.get(fn, 0) + 1


class StepGraph:
    """A loop's step captured once as a CUDA graph and replayed.

    `step` updates static buffers in place (the loop's state, a step
    counter on the device) and reads nothing back to the host, so a replay
    is one more step. `capture` (or the first `run`) runs the step once
    eagerly on a side stream (it builds the kernels and warms up cuBLAS and
    autograd on the stream that captures, and it is the loop's first
    step), releases the allocator's cache to the graph's pool, then
    captures the step on that stream; `run` replays it for the remaining
    steps. Given `restore`, the tensors that the step changes, the warm-up
    is put back instead (those tensors and the generators' states) and is
    no step of the loop.

    A generator in `generators` is registered with the graph; PyTorch
    writes its seed and offset to the device only for a graph whose own
    capture drew from it, so the step must draw from it, and after each
    replay the host sets its offset to where one eager step leaves it
    (`increments`).

    Given `cond` = (stopped, live), two 0-d bool tensors on the card, the
    step is the body of an IF conditional node (`add_conditional`) in an
    outer graph, which draws one number from each generator (so that its
    replay writes their seed and offset where the body's kernels read
    them), runs the body only while not stopped, and then runs `tail`,
    whether the body ran or not. Its replays record no steps: the device
    decides whether the step ran.

    With `mesh`, the step's collectives on a device mesh (NCCL, which
    captures its kernels from 2.9.6 on: `core/mesh.require_graph_nccl`) are
    captured with it, and the route is 'mesh_captured'. The eager warm-up
    makes each process group's first NCCL call, which creates its
    communicator, so no capture does. Its captures use
    capture_error_mode='thread_local': under 'global', a CUDA call that
    another thread makes during the capture invalidates it, and
    ProcessGroupNCCL's watchdog thread queries the events of earlier
    collectives (the warm-up's) at any time. A host read in the capturing
    thread still raises, as on one device, whose captures keep 'global'.

    The warm-up step (where it is one of the loop's) and the replays are
    recorded on the span open around them (`timing.count_steps`). Kernel
    wrappers that launch inside the step are counted once per replay
    (`count_launch`). Nothing falls back: a failed capture or replay
    raises, and a failed capture first leaves the current stream and the
    generators as it found them (`end_failed_capture`), so the process
    draws and captures again.
    """

    def __init__(self, name: str, step: Callable[[], None], device,
                 generators: Sequence[torch.Generator] = (),
                 restore: Optional[Sequence[torch.Tensor]] = None,
                 cond: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 tail: Optional[Callable[[], None]] = None,
                 mesh: bool = False):
        if mesh:
            cm.require_graph_nccl()
        self.name, self.step = name, step
        self.route = 'mesh_captured' if mesh else 'captured'
        self.error_mode = 'thread_local' if mesh else 'global'
        self.device = torch.device(device)
        self.generators = list(generators)
        self.restore, self.cond, self.tail = restore, cond, tail
        self.graph = self.body = None
        self.launches: Dict[Callable, int] = {}
        self.increments = [0] * len(self.generators)
        self.replays = 0

    def run(self, k: int) -> None:
        """k more steps of the loop; inside a span that takes device time
        (`core/timing.device_begin`), the replays are timed on the
        device."""
        if k <= 0:
            return
        if self.graph is None:
            self.capture()
            k -= self.restore is None
        timed = timing.device_begin()
        self.replay(k)
        if timed is not None:
            timed.device_end()

    def _warmup(self, stream: torch.cuda.Stream) -> None:
        """One eager step on `stream`, with each generator's increment;
        given `restore`, what it changed is then put back."""
        dev, gens = self.device, self.generators
        saved = (None if self.restore is None
                 else [t.clone() for t in self.restore])
        states = [g.get_state() for g in gens]
        offsets = [g.get_offset() for g in gens]
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.step()
        current.wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.increments = [g.get_offset() - o for g, o in zip(gens, offsets)]
        if saved is None:
            if self.cond is None:
                timing.count_steps(self.name, self.route, 1)
            return
        with torch.no_grad():
            for t, v in zip(self.restore, saved):
                t.copy_(v)
        for g, st in zip(gens, states):
            g.set_state(st)

    def capture(self) -> None:
        """The warm-up step and the capture, once."""
        global _capturing
        if self.graph is not None:
            return
        dev, gens = self.device, self.generators
        stream = torch.cuda.Stream(dev)
        with timing.span('graphs.capture', loop=self.name) as cap:
            with timing.span('graphs.warmup'):
                self._warmup(stream)
                offsets = [g.get_offset() for g in gens]
                torch.cuda.empty_cache()
            with timing.span('graphs.record'):
                body = torch.cuda.CUDAGraph(keep_graph=True)
                for g in gens:
                    body.register_generator_state(g)
                _capturing = {}
                try:
                    self._capture_into(body, stream, self.step)
                finally:
                    self.launches, _capturing = _capturing, None
                nodes, kernels = node_counts(body)
                if self.cond is None:
                    body.instantiate()
                    self.graph = body
                else:
                    outer = torch.cuda.CUDAGraph()
                    for g in gens:
                        outer.register_generator_state(g)

                    def outer_step():
                        for g in gens:
                            torch.rand(1, generator=g, device=dev)
                        add_conditional(stream, body, *self.cond)
                        if self.tail is not None:
                            self.tail()
                    self._capture_into(outer, stream, outer_step)
                    self.body, self.graph = body, outer
                for g, o in zip(gens, offsets):
                    g.set_offset(o)
                torch.cuda.synchronize(dev)
            cap.set(nodes=nodes, kernel_nodes=kernels)

    def _capture_into(self, graph: torch.cuda.CUDAGraph,
                      stream: torch.cuda.Stream, fn: Callable[[], None]):
        """fn() captured into `graph` on `stream`. A capture that raises
        leaves the current stream and the generators as it found them
        before the error propagates (`end_failed_capture`)."""
        current = torch.cuda.current_stream(self.device)
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode=self.error_mode):
                fn()
        except BaseException as err:
            torch.cuda.set_stream(current)
            try:
                end_failed_capture(self.device, self.generators,
                                   self.error_mode)
            except Exception as repair:
                raise RuntimeError(
                    f'the capture of {self.name!r} failed ({err}), and so '
                    f'did ending its generators\' capture ({repair}): the '
                    'CUDA generators cannot draw again in this process; '
                    'restart it') from err
            raise

    def replay(self, k: int) -> None:
        """k replays of the captured step."""
        gens = self.generators
        for _ in range(k):
            offsets = [g.get_offset() for g in gens]
            self.graph.replay()
            for g, o, inc in zip(gens, offsets, self.increments):
                g.set_offset(o + inc)
        for fn, c in self.launches.items():
            fn.launches += c * k
        self.replays += k
        if self.cond is None:
            timing.count_steps(self.name, self.route, k)


def end_failed_capture(device, generators: Sequence[torch.Generator] = (),
                       capture_error_mode: str = 'global') -> None:
    """Ends what a failed `torch.cuda.graph` capture left open on `device`:
    its default CUDA generator and `generators`, the ones that capture
    registered. A capture begins the capture of each generator registered
    on its graph, the default one always, and only a capture that ends
    cleanly ends them (`CUDAGraph::capture_end`). One that raised leaves
    them capturing, and each then refuses every later draw outside a
    capture, for the rest of the process. A capture of one small kernel,
    with the same generators registered, that ends cleanly ends theirs:
    their seeds and offsets are as before the failed capture."""
    device = torch.device(device)
    fix = torch.cuda.CUDAGraph()
    for g in generators:
        fix.register_generator_state(g)
    with torch.cuda.graph(fix, stream=torch.cuda.Stream(device),
                          capture_error_mode=capture_error_mode):
        torch.zeros(1, device=device)
    del fix


class EagerSteps:
    """The plain version of a `StepGraph`: the same step, called op by op."""

    replays = 0

    def __init__(self, name: str, step: Callable[[], None], route: str):
        self.name, self.step, self.route = name, step, route

    def run(self, k: int) -> None:
        for _ in range(k):
            self.step()
        timing.count_steps(self.name, self.route, k)


def steps_runner(name: str, step: Callable[[], None], device,
                 generators: Sequence[torch.Generator] = (),
                 mesh: bool = False):
    """What runs a loop's `step`: where `captures(device)`, a `StepGraph`,
    on one device or (`mesh`, its collectives captured too) on a device
    mesh; else the step called op by op."""
    device = torch.device(device)
    if captures(device):
        return StepGraph(name, step, device, generators, mesh=mesh)
    route = ('mesh' if mesh else 'eager' if device.type == 'cuda'
             else 'cpu')
    return EagerSteps(name, step, route)
