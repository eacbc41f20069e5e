"""Losses, batch sampling and the training loop.

jamie_tpu's `TrainState` has no namesake: `FitState` holds the same fit
with Adam's state as flat `mu`, `nu` and `count` fields in place of an
optax state tree."""

from .losses import (
    LOSS_NAMES, kl_anneal, kl_divergence, reconstruction_loss,
    latent_consistency_loss, f_reconstruction_loss, row_normalize,
)
from .sampling import detect_sampling_method, make_sampler
from .trainer import FitState, JamieTrainer

__all__ = [
    'LOSS_NAMES', 'kl_anneal', 'kl_divergence', 'reconstruction_loss',
    'latent_consistency_loss', 'f_reconstruction_loss', 'row_normalize',
    'detect_sampling_method', 'make_sampler', 'JamieTrainer', 'FitState',
]
