"""Coupled variational autoencoder — the JAMIE model, as an nn.Module.

Reference parity: `jamie_tpu/models/coupled_vae.py`, itself the reference
`edModelVar` (jamie/model.py:116-282):

- per-modality encoder MLP `in -> 2*in -> in`, each block
  Linear + BatchNorm + LeakyReLU(0.01) + Dropout;
- per-modality `fc_mu` / `fc_var` heads `in -> out`;
- reparameterized sampling z = mu + (exp(logvar/2) + 1e-7) * eps in train
  mode, z = mu in eval mode;
- `combine_latents`: sigma-weighted mixing of each modality's latent with
  the correspondence-weighted other-modality latent;
- per-modality decoder MLP `out -> in -> 2*in -> in` (final layer linear);
- `impute` = encode(from) -> refactor -> decode(to); `embed_one` = mu head;
- default dropout 0.6 if `max(input_dim) > 64` else 0.

`compute_dtype` (jamie_tpu/models/coupled_vae.py:51-73, 86-91, 166, 196):
parameters stay float32; `encode_one` and `decode_one` cast the activations
to the compute dtype, and every layer computes in its input's dtype. A
bfloat16 dense layer is `x @ W.bf16 + b.bf16`; a bfloat16 BatchNorm takes
its statistics and `(x - mean) rsqrt(var + eps) scale + bias` in float32
and casts the result back (flax 0.12's `force_float32_reductions`), its
running stats float32. `combine_latents` promotes a bfloat16 latent with
the float32 `sigma` to float32, as jax's type promotion does.

Layers live in one `nn.ModuleDict` under jamie_tpu's flax names
(`enc{i}_b{j}`, `fc_mu{i}`, `fc_var{i}`, `dec{i}_b{j}`, `dec{i}_out`), so
`models/convert.py` maps variables across by name. BatchNorm follows flax,
not `nn.BatchNorm1d`: the running variance is updated with the *biased*
batch variance (E[x^2] - E[x]^2), momentum 0.9 on the old value.
Randomness (dropout masks, reparameterization noise) is drawn from the
`torch.Generator` passed to `forward`, or the noise is passed in.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from ..core.dtypes import bf16_matmul


class TorchDense(nn.Module):
    """Linear layer with torch.nn.Linear's default init U(-1/sqrt(in),
    1/sqrt(in)) for weight (out, in) and bias, computing in its input's
    dtype. matmul_bf16 runs only the matmul on bf16 operands with an f32
    result, rounded to the input's dtype before the bias."""

    def __init__(self, in_features: int, features: int,
                 matmul_bf16: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
        self.weight = nn.Parameter(
            torch.empty(features, in_features).uniform_(
                -bound, bound, generator=generator))
        self.bias = nn.Parameter(
            torch.empty(features).uniform_(-bound, bound, generator=generator))
        self.matmul_bf16 = matmul_bf16

    def forward(self, x):
        if self.matmul_bf16:
            return (bf16_matmul(x, self.weight.T).to(x.dtype)
                    + self.bias.to(x.dtype))
        if x.dtype == torch.float32:
            return Fn.linear(x, self.weight, self.bias)
        return x @ self.weight.T.to(x.dtype) + self.bias.to(x.dtype)


class FlaxBatchNorm(nn.Module):
    """BatchNorm with flax.linen.BatchNorm's semantics (momentum 0.9 on the
    running value, eps 1e-5, biased batch variance E[x^2] - E[x]^2 clipped
    at 0 for both the normalization and the running update). Statistics and
    the normalization are float32 whatever the input's dtype; the output
    is cast back to it."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))    # flax 'scale'
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean = xf.mean(0)
            var = torch.clamp((xf * xf).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return ((xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
                + self.bias).to(x.dtype)


class _Block(nn.Module):
    """Linear + BatchNorm + LeakyReLU + Dropout (one reference MLP block)."""

    def __init__(self, in_features: int, features: int, dropout: float,
                 matmul_bf16: bool, generator=None):
        super().__init__()
        self.dense = TorchDense(in_features, features, matmul_bf16, generator)
        self.bn = FlaxBatchNorm(features)
        self.dropout = dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = Fn.leaky_relu(self.bn(self.dense(x)), negative_slope=0.01)
        if self.training and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return x


def combine_latents(zs: Sequence[torch.Tensor], corr: torch.Tensor,
                    sigma: torch.Tensor) -> List[torch.Tensor]:
    """Sigma-weighted latent aggregation (jamie/model.py:245-259):
    combined[i] = (s_i z_i + s_j M_i z_j) / (s_i + s_j corr.sum(other)),
    with M_0 = corr, M_1 = corr^T. corr is cast to the latents' dtype; the
    products with sigma take the promotion of sigma's and the latents'
    dtypes (float32 for bfloat16 latents, as in jax)."""
    z0, z1 = zs
    s0, s1 = sigma[0], sigma[1]
    dt = torch.promote_types(sigma.dtype, z0.dtype)
    corr = corr.to(z0.dtype)
    num0 = s0 * z0.to(dt) + s1 * (corr @ z1).to(dt)
    den0 = s0 + s1 * torch.sum(corr, dim=1).to(dt)[:, None]
    num1 = s1 * z1.to(dt) + s0 * (corr.T @ z0).to(dt)
    den1 = s1 + s0 * torch.sum(corr, dim=0).to(dt)[:, None]
    return [num0 / den0, num1 / den1]


class CoupledVAE(nn.Module):
    """Two coupled per-modality VAEs with correspondence-mixed latents.

    forward(xs, corr) returns (zs, combined, reconstructed, mus, logvars),
    like the reference forward (jamie/model.py:264-275). compute_dtype is
    the activations' dtype (torch.float32 or torch.bfloat16).
    """

    def __init__(self, input_dim: Tuple[int, ...], output_dim: int,
                 dropout: Optional[float] = None, matmul_bf16: bool = False,
                 seed: int = 0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim = tuple(int(d) for d in input_dim)
        self.output_dim = int(output_dim)
        self.dropout = dropout
        self.matmul_bf16 = bool(matmul_bf16)
        self.compute_dtype = compute_dtype
        p = self.dropout_rate
        gen = torch.Generator().manual_seed(seed)
        layers = {}
        for i, d in enumerate(self.input_dim):
            out = self.output_dim
            layers[f'enc{i}_b0'] = _Block(d, 2 * d, p, matmul_bf16, gen)
            layers[f'enc{i}_b1'] = _Block(2 * d, d, p, matmul_bf16, gen)
            layers[f'fc_mu{i}'] = TorchDense(d, out, matmul_bf16, gen)
            layers[f'fc_var{i}'] = TorchDense(d, out, matmul_bf16, gen)
            layers[f'dec{i}_b0'] = _Block(out, d, p, matmul_bf16, gen)
            layers[f'dec{i}_b1'] = _Block(d, 2 * d, p, matmul_bf16, gen)
            layers[f'dec{i}_out'] = TorchDense(2 * d, d, matmul_bf16, gen)
        self.layers = nn.ModuleDict(layers)
        # Trainable modality-mixing weights, init U[0,1) (jamie/model.py:220)
        self.sigma = nn.Parameter(torch.rand(len(self.input_dim),
                                             generator=gen))

    @property
    def num_modalities(self) -> int:
        return len(self.input_dim)

    @property
    def dropout_rate(self) -> float:
        if self.dropout is not None:
            return self.dropout
        return 0.6 if max(self.input_dim) > 64 else 0.0

    # --- pieces -----------------------------------------------------------
    def encode_one(self, x, i: int, generator=None):
        h = self.layers[f'enc{i}_b0'](x.to(self.compute_dtype), generator)
        return self.layers[f'enc{i}_b1'](h, generator)

    def refactor_one(self, h, i: int, generator=None, noise=None):
        mu = self.layers[f'fc_mu{i}'](h)
        logvar = self.layers[f'fc_var{i}'](h)
        if not self.training:
            return mu, mu, logvar
        # std + 1e-7 rounding protection (jamie/model.py:236-239), in
        # mu's dtype as jamie_tpu draws and adds it
        std = torch.exp(logvar / 2) + 1e-7
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        return mu + std * noise.to(mu.dtype), mu, logvar

    def decode_one(self, z, i: int, generator=None):
        h = self.layers[f'dec{i}_b0'](z.to(self.compute_dtype), generator)
        h = self.layers[f'dec{i}_b1'](h, generator)
        return self.layers[f'dec{i}_out'](h)

    # --- reference API ----------------------------------------------------
    def forward(self, xs, corr, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
        """noise: optional per-modality reparameterization noise (train
        mode); otherwise it is drawn from `generator`."""
        zs, mus, logvars = [], [], []
        for i in range(self.num_modalities):
            h = self.encode_one(xs[i], i, generator)
            z, mu, logvar = self.refactor_one(
                h, i, generator, None if noise is None else noise[i])
            zs.append(z)
            mus.append(mu)
            logvars.append(logvar)
        combined = combine_latents(zs, corr, self.sigma)
        x_hat = [self.decode_one(combined[i], i, generator)
                 for i in range(self.num_modalities)]
        return zs, combined, x_hat, mus, logvars

    def impute(self, x, from_mod: int, to_mod: int, generator=None):
        """Cross-modal imputation: encode `from_mod`, decode `to_mod`
        (jamie/model.py:277-282). No combine step, as in the reference."""
        h = self.encode_one(x, from_mod, generator)
        z, _, _ = self.refactor_one(h, from_mod, generator)
        return self.decode_one(z, to_mod, generator)

    def embed_one(self, x, i: int):
        """Single-modality latent: fc_mus[i](encoders[i](x)), the mean head."""
        return self.layers[f'fc_mu{i}'](self.encode_one(x, i))
