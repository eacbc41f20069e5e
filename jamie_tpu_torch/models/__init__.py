"""The coupled VAE and its variable conversion to and from flax."""

from .coupled_vae import CoupledVAE, TorchDense, combine_latents

__all__ = ['CoupledVAE', 'TorchDense', 'combine_latents']
