"""K4: all-pairs shortest paths on the card, a blocked Floyd-Warshall in
CUDA C++ (`csrc/floyd_warshall.cu`, built with nvcc and bound with ctypes
by `core/_build.py`).

Replaces no TPU kernel: `jamie_tpu` closes the geodesic kNN graph on the
host with scipy's all-pairs Dijkstra (`jamie_tpu/ops/distances.py:
429-460`), as the port did, where it took ~60% of a 3654-cell geodesic fit.
What bounds it on an H100: n^3 min-plus pairs, each an FP64 add and an FP64
compare, on the card's FP64 lanes; the tiling (the source's note) keeps
the bytes, one read and one write of the matrix a pivot round, below that.

`floyd_warshall(w)` closes a padded (n, n) float64 matrix in place: the
kernel for a CUDA tensor, the plain PyTorch version
`floyd_warshall_plain` (the same blocked phases) for a CPU tensor, and any
other input raises. `floyd_warshall.launches` counts closures, one per
call. `shortest_paths(graph, device)` is the geodesic route's closure on
the card: it uploads the graph's edges, scatters them into the padded
matrix (`edge_matrix`), closes it and fills unreachable pairs as the host
route does.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core import _build
from ..core.graphs import count_launch

TILE = 64            # pivot block: TILE in the source


def rounds(n: int) -> int:
    """Pivot rounds of a closure of n vertices."""
    return -(-n // TILE)


def floyd_warshall_plain(w: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version, in place: per pivot block the diagonal tile
    closed alone, then its row and column panels against it, then every
    entry against the min-plus product of the two panels. n must be a
    multiple of `tile`."""
    n = w.shape[0]
    for s in range(0, n, tile):
        k = slice(s, s + tile)
        d = w[k, k]
        for kk in range(tile):
            torch.minimum(d, d[:, kk:kk + 1] + d[kk:kk + 1, :], out=d)
        row, col = w[k, :], w[:, k]
        for kk in range(tile):
            torch.minimum(row, d[:, kk:kk + 1] + row[kk:kk + 1, :], out=row)
            torch.minimum(col, col[:, kk:kk + 1] + d[kk:kk + 1, :], out=col)
        # the closed panels do not change under their own product
        row, col = row.clone(), col.clone()
        for kk in range(tile):
            torch.minimum(w, col[:, kk:kk + 1] + row[kk:kk + 1, :], out=w)
    return w


def library():
    """K4's closure, built on first use."""
    lib = _build.load('floyd_warshall')
    fn = lib.floyd_warshall_f64
    if fn.argtypes is None:
        if lib.floyd_warshall_tile() != TILE:
            raise RuntimeError('csrc/floyd_warshall.cu and ops/shortest_paths'
                               '.py disagree on TILE')
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def floyd_warshall(w: torch.Tensor) -> torch.Tensor:
    """Close w (n, n), a contiguous float64 matrix of edge weights (+inf
    where there is no edge, 0 on the diagonal, none negative) with n a
    multiple of TILE, in place; returns w."""
    if w.device.type == 'cpu':
        return floyd_warshall_plain(w)
    if w.device.type != 'cuda':
        raise ValueError(f'floyd_warshall runs on CUDA or CPU tensors, got '
                         f'{w.device}')
    if w.dtype != torch.float64:
        raise TypeError(f'w must be float64, got {w.dtype}')
    n = w.shape[0]
    if w.dim() != 2 or w.shape[1] != n or not w.is_contiguous():
        raise ValueError('w must be a contiguous square matrix')
    if n % TILE or n == 0 or n >= 2 ** 31:
        raise ValueError(f'w must have a positive multiple of {TILE} rows '
                         f'below 2^31, got {n}')
    kernel = library()
    with torch.cuda.device(w.device):
        err = kernel(w.data_ptr(), n,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'floyd_warshall kernel launch failed: cudaError '
                           f'{err}')
    count_launch(floyd_warshall)
    return w


floyd_warshall.launches = 0


def edge_matrix(graph: np.ndarray, device) -> torch.Tensor:
    """The padded float64 matrix K4 closes, on `device`, from the edges of
    the dense host graph `graph` (n, n): only its nonzero entries travel;
    0 off the diagonal is no edge, as a CSR copy drops it, and of two
    stored directions the smaller counts, as in scipy's
    `shortest_path(directed=False)`; +inf elsewhere, 0 on the diagonal."""
    n = graph.shape[0]
    npad = TILE * rounds(n)
    # torch's nonzero on the host, several times numpy's on a 2-D array
    flat = torch.from_numpy(np.ascontiguousarray(graph)).view(-1)
    at = flat.nonzero().squeeze(1)
    v = flat[at].to(device=device, dtype=torch.float64)
    at = at.to(device)
    r, c = at // n, at % n
    w = torch.full((npad, npad), math.inf, dtype=torch.float64,
                   device=device)
    w.view(-1).scatter_reduce_(0, torch.cat([r * npad + c, c * npad + r]),
                               torch.cat([v, v]), 'amin')
    w.diagonal().zero_()
    return w


def shortest_paths(graph: np.ndarray, device) -> np.ndarray:
    """All-pairs shortest paths of the weighted undirected graph `graph`
    (`edge_matrix`'s reading) as a host float32 (n, n) array: float64 path
    sums closed on `device`, unreachable pairs set to the largest finite
    distance there, one copy to the host."""
    n = graph.shape[0]
    sp = floyd_warshall(edge_matrix(graph, device))[:n, :n]
    unreachable = torch.isinf(sp)
    sp.masked_fill_(unreachable, 0.0)     # distances are >= 0
    sp.masked_fill_(unreachable, sp.max())
    return sp.float().cpu().numpy()
