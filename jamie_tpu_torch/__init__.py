"""jamie_tpu_torch — JAMIE on PyTorch and CUDA, for one NVIDIA H100.

The PyTorch port of `jamie_tpu`, module for module, with the TPU's Pallas
kernels rewritten by hand for Hopper: the prime-dual iteration tail in
Triton (`ops/pd_update.py`) and the pairwise euclidean distance in CUDA C++
(`ops/pairwise.py`, `csrc/`). It imports nothing of jax or `jamie_tpu`.

    from jamie_tpu_torch import JAMIE
    jm = JAMIE()                        # the CUDA card; JAMIE(device='cpu')
    integrated = jm.fit_transform(dataset=[rna, atac])
    imputed_atac = jm.modal_predict(rna, 0)

`io` reads raw 10x / .h5ad / mtx files, `normalize` holds the count
transforms, `evaluation` the metrics and the occlusion/SHAP explanations,
`compare` the five alignment baselines, `figures` the notebooks' plots,
`utils` the triage helpers and the imputation baselines, `nn_funcs` the
kNN graphs and legacy losses. `core.mesh` is the device mesh on
`torch.distributed` (`JAMIE(mesh=...)`, SPMD: every rank calls the same
entry point), `multichip` its checks on local processes.
"""

from .core.dtypes import pin_fp32_matmuls

pin_fp32_matmuls()

from ._meta import __version__, __reference_version__  # noqa: E402
from .config import JamieConfig, config_from_kwargs  # noqa: E402
from .estimator import JAMIE  # noqa: E402
from .models import CoupledVAE, SimpleCoupledAE  # noqa: E402
from .ops.sparse import SparseRows  # noqa: E402
from .preprocess import PCA, Preprocessor  # noqa: E402
from . import (compare, evaluation, figures, io, nn_funcs,  # noqa: E402
               normalize, utils)

__all__ = [
    '__version__', '__reference_version__',
    'JAMIE', 'JamieConfig', 'config_from_kwargs',
    'compare', 'evaluation', 'figures', 'io', 'nn_funcs', 'normalize',
    'utils',
    'PCA', 'Preprocessor', 'SparseRows', 'CoupledVAE', 'SimpleCoupledAE',
]
