"""Kernels and the device ops built on them.

- `pd_update`: K1/K2, the prime-dual iteration tail (Triton).
- `pairwise`: K3, pairwise (squared) euclidean distances (CUDA C++).
- `block_tail`: the coupled VAE block's BatchNorm + LeakyReLU + dropout
  tail, one kernel forward and one backward (Triton).
- `shortest_paths`: K4, the geodesic graph's all-pairs shortest paths, a
  blocked Floyd-Warshall (CUDA C++).
- `distances`: the distance-matrix dispatch on top of K3 (its entry
  points are exported here, as in jamie_tpu.ops).
- `sparse`: `SparseRows` (padded-ELL priors / top-k F) and its batch gather.
- `lowrank`: `LowRankF` / `SparseLandmarkF`, the landmark F layouts.
"""

from .distances import (
    pairwise_distance, pairwise_sq_euclidean, dataset_distance_matrix,
    geodesic_distances,
)
from .block_tail import block_tail_backward, block_tail_forward
from .pairwise import pairwise_euclidean
from .pd_update import fused_pd_grad_update, fused_pd_update
from .shortest_paths import floyd_warshall

KERNEL_WRAPPERS = (fused_pd_grad_update, fused_pd_update, pairwise_euclidean,
                   floyd_warshall, block_tail_forward, block_tail_backward)


__all__ = [
    'pairwise_distance', 'pairwise_sq_euclidean', 'dataset_distance_matrix',
    'geodesic_distances', 'pairwise_euclidean', 'fused_pd_grad_update',
    'fused_pd_update', 'floyd_warshall', 'block_tail_forward',
    'block_tail_backward', 'KERNEL_WRAPPERS',
    'reset_launch_counts', 'launch_counts',
]


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
