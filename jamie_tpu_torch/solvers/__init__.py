"""Correspondence solvers and the legacy projections: the dense prime-dual
F-estimator and its landmark (low-rank) extension, the Hungarian pairs,
the experimental low-rank correspondence, t-SNE and UMAP.

As in jamie_tpu, `solvers.prime_dual` is the function: reach the module
itself through `importlib.import_module('jamie_tpu_torch.solvers.prime_dual')`.
"""
from .prime_dual import prime_dual
from .assignment import hungarian_pairs

__all__ = ['prime_dual', 'hungarian_pairs']
