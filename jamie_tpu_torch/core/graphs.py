"""Conditional nodes in captured CUDA graphs (`csrc/graph_cond.cu`).

The trainer captures one epoch as a CUDA graph and replays it under an IF
conditional node on `not stopped`, the counterpart of jamie_tpu's
`lax.cond` over post-stop epochs (jamie_tpu/train/trainer.py:499-530).
PyTorch's `CUDAGraph` does not capture conditional nodes itself, so
`add_conditional` adds one, with a copy of an already captured graph as its
body, to the graph that a stream is capturing. The library is built with
nvcc on first use (`ops/_build.py`); nothing here runs on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops import _build

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
