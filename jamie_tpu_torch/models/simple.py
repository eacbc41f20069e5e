"""Small non-variational coupled autoencoder.

Reference parity: `jamie_tpu/models/simple.py` (`SimpleJAMIEModel`,
jamie/utilities.py:681-718) — one Linear+BatchNorm encoder and decoder per
modality, latents mixed by the (unweighted) correspondence average. Layers
carry jamie_tpu's flax names (`enc{i}`, `enc{i}_bn`, `dec{i}`, `dec{i}_bn`),
so `models/convert.py` maps variables across; train or eval mode is the
module's (`.train()` / `.eval()`), where flax passes `train=`.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .coupled_vae import FlaxBatchNorm, TorchDense


class SimpleCoupledAE(nn.Module):

    def __init__(self, input_dim: Tuple[int, ...], output_dim: int,
                 seed: int = 0):
        super().__init__()
        self.input_dim = tuple(int(d) for d in input_dim)
        self.output_dim = int(output_dim)
        gen = torch.Generator().manual_seed(seed)
        for i, d in enumerate(self.input_dim):
            self.add_module(f'enc{i}', TorchDense(d, self.output_dim,
                                                  generator=gen))
            self.add_module(f'enc{i}_bn', FlaxBatchNorm(self.output_dim))
            self.add_module(f'dec{i}', TorchDense(self.output_dim, d,
                                                  generator=gen))
            self.add_module(f'dec{i}_bn', FlaxBatchNorm(d))

    def forward(self, xs, corr):
        """(embedded, reconstructed), one tensor per modality."""
        n = len(self.input_dim)
        assert n == 2 and corr is not None, '`corr` must be provided.'
        layer = self.get_submodule
        embedded = [layer(f'enc{i}_bn')(layer(f'enc{i}')(xs[i]))
                    for i in range(n)]
        combined = [
            (embedded[0] + corr @ embedded[1])
            / (1.0 + torch.sum(corr, dim=1)[:, None]),
            (embedded[1] + corr.T @ embedded[0])
            / (1.0 + torch.sum(corr, dim=0)[:, None]),
        ]
        reconstructed = [layer(f'dec{i}_bn')(layer(f'dec{i}')(combined[i]))
                         for i in range(n)]
        return embedded, reconstructed


# Reference name (jamie/utilities.py:681): construct with the same
# (input_dim, output_dim) args.
SimpleJAMIEModel = SimpleCoupledAE
