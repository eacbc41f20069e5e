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

On a device mesh (`shard_(mesh)`, jamie_tpu's GSPMD layout of
trainer.py:345-356):

- a batch split over the 'data' axis (`forward(..., rows=Split)`) draws
  every dropout mask and noise at the whole batch's shape from the one
  generator and takes its rows, so a sharded step follows the unsharded
  random stream; BatchNorm takes the whole batch's statistics with one
  all-reduce of (sum, sum of squares, count), on the CPU and the card
  alike (`nn.SyncBatchNorm` runs on the card only); `combine_latents`
  all-gathers the other modality's latents and reduce-scatters the
  transposed product;
- the 'model' axis shards parameters by `core.mesh.param_spec` (tensor
  parallelism for wide modalities): a kernel sharded on its output dim is
  a column-parallel Linear, whose BatchNorm, LeakyReLU and dropout stay
  local to its features; one sharded on its input dim is a row-parallel
  Linear, reduced (all-reduce, or reduce-scatter where the next features
  are sharded too). The heads' and decoders' outputs are gathered whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from ..core import mesh as cm
from ..core.dtypes import bf16_matmul
from ..ops.block_tail import block_tail


@dataclasses.dataclass(frozen=True)
class _TPLayout:
    """A TorchDense's place on the model axis (its process group): its
    kernel sharded on 'out' (column-parallel), 'in' (row-parallel) or
    None; whether its input arrives feature-sharded, whether its output
    leaves so, and whether the output is gathered whole (the heads and the
    decoder outputs)."""
    group: object
    kernel: Optional[str]
    x_sharded: bool
    out_sharded: bool
    gather_out: bool
    in_split: Optional[cm.Split]
    out_split: Optional[cm.Split]


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
        self.tp: Optional[_TPLayout] = None

    def forward(self, x):
        return self._linear(x) if self.tp is None else self._forward_tp(x)

    def product(self, x):
        """x W^T in x's dtype, without the bias."""
        if self.matmul_bf16:
            return bf16_matmul(x, self.weight.T).to(x.dtype)
        if x.dtype == torch.float32:
            return Fn.linear(x, self.weight)
        return x @ self.weight.T.to(x.dtype)

    def _linear(self, x):
        if x.dtype == torch.float32 and not self.matmul_bf16:
            return Fn.linear(x, self.weight, self.bias)
        return self.product(x) + self.bias.to(x.dtype)

    def _forward_tp(self, x):
        """The layer with its kernel sharded on the model axis (or
        replicated, between sharded layers)."""
        tp = self.tp
        if tp.kernel == 'in':
            if not tp.x_sharded:
                x = cm.scatter_to(x, tp.in_split)
            if self.matmul_bf16:
                y = bf16_matmul(x, self.weight.T)
            elif x.dtype == torch.float32:
                y = Fn.linear(x, self.weight)
            else:
                y = x @ self.weight.T.to(x.dtype)
            y = (cm.reduce_scatter(y, tp.out_split) if tp.out_sharded
                 else cm.reduce_from(y, tp.group))
            y = y.to(x.dtype) + self.bias.to(x.dtype)
        else:
            if tp.x_sharded:
                x = cm.gather_from(x, tp.in_split)
            if tp.kernel == 'out':
                x = cm.copy_to(x, tp.group)
            y = self._linear(x)
        if tp.gather_out and tp.out_sharded:
            y = cm.gather_from(y, tp.out_split)
        return y


class FlaxBatchNorm(nn.Module):
    """BatchNorm with flax.linen.BatchNorm's semantics (momentum 0.9 on the
    running value, eps 1e-5, biased batch variance E[x^2] - E[x]^2 clipped
    at 0 for both the normalization and the running update). Statistics and
    the normalization are float32 whatever the input's dtype (float64 for
    a float64 input); the output is cast back to it. With `data_group` set
    (a batch split over the 'data' axis), the statistics are the whole
    batch's: one all-reduce of the local sums, squared sums and row
    count."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))    # flax 'scale'
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.momentum = momentum
        self.eps = eps
        self.data_group = None

    def _batch_stats(self, xf):
        if self.data_group is None:
            mean = xf.mean(0)
            return mean, (xf * xf).mean(0)
        f = xf.shape[1]
        s = cm.all_reduce(torch.cat([xf.sum(0), (xf * xf).sum(0),
                                     xf.new_full((1,), xf.shape[0])]),
                          self.data_group)
        count = s[2 * f].detach()
        return s[:f] / count, s[f:2 * f] / count

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, sq = self._batch_stats(xf)
            var = torch.clamp(sq - mean * mean, min=0.0)
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
    """Linear + BatchNorm + LeakyReLU + Dropout (one reference MLP block).

    In train mode on a CUDA device, with the batch and the features whole
    on it (no `data_group`, no model-axis layout), everything after the
    Linear's matmul is one kernel forward and one backward
    (`ops/block_tail.py`); elsewhere (the CPU, eval mode, a mesh) the
    composed ops run, which are what those kernels are held to. Both draw
    the dropout mask by the same call at the same point of the random
    stream."""

    def __init__(self, in_features: int, features: int, dropout: float,
                 matmul_bf16: bool, generator=None):
        super().__init__()
        self.dense = TorchDense(in_features, features, matmul_bf16, generator)
        self.bn = FlaxBatchNorm(features)
        self.dropout = dropout

    def takes_kernel(self, device: torch.device) -> bool:
        """Whether a call on `device` in the module's mode takes the block
        tail's kernels."""
        return (self.training and device.type == 'cuda'
                and self.bn.data_group is None and self.dense.tp is None)

    def fused(self, x, generator: Optional[torch.Generator] = None):
        """The block through `ops.block_tail` (the kernels on the card, their
        plain versions on the CPU): the Linear's product, then the tail."""
        z = self.dense.product(x)
        keep = 1.0 - self.dropout
        mask = (torch.rand(z.shape, generator=generator, device=z.device)
                < keep) if self.dropout > 0 else None
        return block_tail(z, self.dense.bias, self.bn, mask, keep)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                rows: Optional[cm.Split] = None):
        if rows is None and self.takes_kernel(x.device):
            return self.fused(x, generator)
        x = Fn.leaky_relu(self.bn(self.dense(x)), negative_slope=0.01)
        if self.training and self.dropout > 0:
            # the mask of the whole batch (and of all features), then this
            # rank's rows and features
            tp = self.dense.tp
            feats = tp is not None and tp.out_sharded
            shape = (x.shape[0] if rows is None else rows.total,
                     tp.out_split.total if feats else x.shape[1])
            keep = 1.0 - self.dropout
            mask = torch.rand(shape, generator=generator,
                              device=x.device) < keep
            if rows is not None:
                mask = rows.local(mask)
            if feats:
                mask = tp.out_split.local(mask)
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return x


@contextlib.contextmanager
def _mode(module: nn.Module, train: Optional[bool]):
    """Run the body with every submodule in train (True) or eval (False)
    mode, then restore each one's own mode; None changes nothing."""
    if train is None:
        yield
        return
    modes = [(m, m.training) for m in module.modules()]
    module.train(bool(train))
    try:
        yield
    finally:
        for m, was in modes:
            m.training = was


def combine_latents(zs: Sequence[torch.Tensor], corr: torch.Tensor,
                    sigma: torch.Tensor,
                    rows: Optional[cm.Split] = None) -> List[torch.Tensor]:
    """Sigma-weighted latent aggregation (jamie/model.py:245-259):
    combined[i] = (s_i z_i + s_j M_i z_j) / (s_i + s_j corr.sum(other)),
    with M_0 = corr, M_1 = corr^T. corr is cast to the latents' dtype; the
    products with sigma take the promotion of sigma's and the latents'
    dtypes (float32 for bfloat16 latents, as in jax).

    rows: a batch split over the 'data' axis. zs and corr are then this
    rank's rows (corr (b, B)); the other modality's latents are
    all-gathered, and corr^T z0 with corr's column sums are
    reduce-scattered to this rank's rows in one collective."""
    z0, z1 = zs
    s0, s1 = sigma[0], sigma[1]
    dt = torch.promote_types(sigma.dtype, z0.dtype)
    corr = corr.to(z0.dtype)
    if rows is None:
        num0 = s0 * z0.to(dt) + s1 * (corr @ z1).to(dt)
        den0 = s0 + s1 * torch.sum(corr, dim=1).to(dt)[:, None]
        num1 = s1 * z1.to(dt) + s0 * (corr.T @ z0).to(dt)
        den1 = s1 + s0 * torch.sum(corr, dim=0).to(dt)[:, None]
        return [num0 / den0, num1 / den1]
    num0 = s0 * z0.to(dt) + s1 * (corr @ cm.all_gather(z1, rows)).to(dt)
    den0 = s0 + s1 * torch.sum(corr, dim=1).to(dt)[:, None]
    t = cm.reduce_scatter(torch.cat([corr.T @ z0,
                                     torch.sum(corr, dim=0)[:, None]], 1),
                          rows)
    num1 = s1 * z1.to(dt) + s0 * t[:, :-1].to(dt)
    den1 = s1 + s0 * t[:, -1:].to(dt)
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

    # --- mesh ---------------------------------------------------------------
    def shard_(self, mesh, wide_threshold: int = 1024
               ) -> Dict[str, Optional[int]]:
        """Place this model on a `core.mesh` DeviceMesh, in place:
        BatchNorm statistics over the 'data' axis, and on a 'model' axis
        of size > 1 every parameter and buffer sliced to this rank's shard
        by `core.mesh.param_spec` (tp_wide_threshold), with each layer's
        column- or row-parallel layout. Returns the specs ({name: sharded
        torch dim or None}; {} without tensor parallelism). Build the
        optimizer afterwards."""
        group = cm.axis_group(mesh, cm.DATA)
        for m in self.modules():
            if isinstance(m, FlaxBatchNorm):
                m.data_group = group
        n = cm.model_axis_size(mesh)
        if n <= 1:
            return {}
        dims = {m: (m.weight.shape[1], m.weight.shape[0])
                for m in self.modules() if isinstance(m, TorchDense)}
        specs = cm.shard_params_tree(self, mesh, wide_threshold)
        prefix = {m: name for name, m in self.named_modules()}
        k, mgroup = cm.axis_index(mesh, cm.MODEL), cm.axis_group(mesh,
                                                                cm.MODEL)

        def split(f):
            return cm.Split(mgroup, (f // n,) * n, k, -1) if f % n == 0 \
                else None

        def layout(name, x_sharded, gather_out=False):
            layer = self.layers[name]
            d = layer.dense if isinstance(layer, _Block) else layer
            w, b = (specs[f'{prefix[d]}.{p}'] for p in ('weight', 'bias'))
            d.tp = _TPLayout(mgroup, {0: 'out', 1: 'in', None: None}[w],
                             x_sharded,
                             b is not None, gather_out, split(dims[d][0]),
                             split(dims[d][1]))
            return b is not None

        for i in range(self.num_modalities):
            h = layout(f'enc{i}_b1', layout(f'enc{i}_b0', False))
            layout(f'fc_mu{i}', h, True)
            layout(f'fc_var{i}', h, True)
            h = layout(f'dec{i}_b1', layout(f'dec{i}_b0', False))
            layout(f'dec{i}_out', h, True)
        return specs

    # --- pieces -----------------------------------------------------------
    # train: jamie_tpu's flag. None keeps the module's mode; True or False
    # runs dropout, the reparameterization noise and BatchNorm in that mode
    # for this call only (a True call updates the running statistics, as a
    # training step does) and leaves every submodule's mode as it was.
    def encode_one(self, x, i: int, train: Optional[bool] = None,
                   generator=None, rows=None):
        with _mode(self, train):
            h = self.layers[f'enc{i}_b0'](x.to(self.compute_dtype),
                                          generator, rows)
            return self.layers[f'enc{i}_b1'](h, generator, rows)

    def refactor_one(self, h, i: int, train: Optional[bool] = None,
                     generator=None, noise=None, rows=None):
        """rows: noise (drawn or given) has the whole batch's rows, of which
        this rank takes its own."""
        with _mode(self, train):
            mu = self.layers[f'fc_mu{i}'](h)
            logvar = self.layers[f'fc_var{i}'](h)
            if not self.training:
                return mu, mu, logvar
        # std + 1e-7 rounding protection (jamie/model.py:236-239), in
        # mu's dtype as jamie_tpu draws and adds it
        std = torch.exp(logvar / 2) + 1e-7
        if noise is None:
            shape = mu.shape if rows is None else (rows.total, mu.shape[1])
            noise = torch.randn(shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        if rows is not None:
            noise = rows.local(noise)
        return mu + std * noise.to(mu.dtype), mu, logvar

    def decode_one(self, z, i: int, train: Optional[bool] = None,
                   generator=None, rows=None):
        with _mode(self, train):
            h = self.layers[f'dec{i}_b0'](z.to(self.compute_dtype),
                                          generator, rows)
            h = self.layers[f'dec{i}_b1'](h, generator, rows)
            return self.layers[f'dec{i}_out'](h)

    # --- reference API ----------------------------------------------------
    def forward(self, xs, corr, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None,
                rows: Optional[cm.Split] = None):
        """noise: optional per-modality reparameterization noise (train
        mode); otherwise it is drawn from `generator`. rows: the batch is
        split over the 'data' axis and xs, corr are this rank's rows (noise
        keeps the whole batch's rows)."""
        zs, mus, logvars = [], [], []
        for i in range(self.num_modalities):
            h = self.encode_one(xs[i], i, generator=generator, rows=rows)
            z, mu, logvar = self.refactor_one(
                h, i, generator=generator,
                noise=None if noise is None else noise[i], rows=rows)
            zs.append(z)
            mus.append(mu)
            logvars.append(logvar)
        combined = combine_latents(zs, corr, self.sigma, rows)
        x_hat = [self.decode_one(combined[i], i, generator=generator,
                                 rows=rows)
                 for i in range(self.num_modalities)]
        return zs, combined, x_hat, mus, logvars

    def impute(self, x, from_mod: int, to_mod: int,
               train: Optional[bool] = None, generator=None):
        """Cross-modal imputation: encode `from_mod`, decode `to_mod`
        (jamie/model.py:277-282). No combine step, as in the reference."""
        with _mode(self, train):
            h = self.encode_one(x, from_mod, generator=generator)
            z, _, _ = self.refactor_one(h, from_mod, generator=generator)
            return self.decode_one(z, to_mod, generator=generator)

    def embed_one(self, x, i: int, train: Optional[bool] = None,
                  generator=None):
        """Single-modality latent: fc_mus[i](encoders[i](x)), the mean head
        (no sampling, whatever the mode)."""
        with _mode(self, train):
            return self.layers[f'fc_mu{i}'](
                self.encode_one(x, i, generator=generator))
