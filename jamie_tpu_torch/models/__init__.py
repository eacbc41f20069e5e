"""The coupled VAE, the small models and their variable conversion to and
from flax."""

from .coupled_vae import CoupledVAE, TorchDense, combine_latents
from .simple import SimpleCoupledAE, SimpleJAMIEModel
from .baselines import (
    BABELMini, SimpleCommonDualModel, SimpleDualModel, SimpleModel,
    SingleModel, predict_nn,
)

__all__ = [
    'CoupledVAE', 'TorchDense', 'combine_latents', 'SimpleCoupledAE',
    'SimpleJAMIEModel',
    'BABELMini', 'SimpleCommonDualModel', 'SimpleDualModel', 'SimpleModel',
    'SingleModel', 'predict_nn',
]
