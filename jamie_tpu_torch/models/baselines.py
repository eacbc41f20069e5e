"""Tiny NN baseline predictors for imputation comparisons.

Reference parity: `jamie_tpu/models/baselines.py` (jamie/utilities.py:
279-474) — `SimpleModel`, `SingleModel`, `SimpleDualModel`,
`SimpleCommonDualModel`, `BABELMini` and the `predict_nn` trainer (AdamW,
MSE, random minibatches), as `nn.Module`s whose layers carry jamie_tpu's
flax names (`models/convert.py` maps variables across). Dropout is active
in train mode (`.train()`, the default) and draws its masks from the
`torch.Generator` passed to `forward`; each module's `loss` is a static
function of tensors, with jamie_tpu's `stop_gradient` as `.detach()`.

`predict_nn` runs on `device` (the card unless the caller asks for
another) with its own AdamW, `optax.adamw(1e-3)`'s formulas (b1 0.9, b2
0.999, eps 1e-8, weight decay 1e-4 on every parameter) rather than
`torch.optim`, whose first construction imports torch.distributed and
dynamo. Batch indices and dropout masks come from one `torch.Generator`
seeded with `seed`, so a run differs from jamie_tpu's (a jax key) while
each step's arithmetic is the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.dtypes import resolve_device
from ..train.trainer import adam_update
from .coupled_vae import TorchDense


def _dropout(x, p: float, training: bool, generator=None):
    """flax nn.Dropout: keep with probability 1 - p and rescale by it."""
    if not training or p == 0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _mse(a, b):
    return torch.mean((a - b) ** 2)


class SimpleModel(nn.Module):
    """fc -> dropout -> fc (utilities.py:279-298)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 16,
                 p: float = 0.6, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.fc1 = TorchDense(input_dim, hidden_dim, generator=gen)
        self.fc2 = TorchDense(hidden_dim, output_dim, generator=gen)
        self.p = p

    def forward(self, x, generator=None):
        h = _dropout(self.fc1(x), self.p, self.training, generator)
        return self.fc2(h)


class SingleModel(nn.Module):
    """dropout -> fc (utilities.py:402-420)."""

    def __init__(self, input_dim: int, output_dim: int, p: float = 0.6,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.fc1 = TorchDense(input_dim, output_dim, generator=gen)
        self.p = p

    def forward(self, x, generator=None):
        return self.fc1(_dropout(x, self.p, self.training, generator))


class _DualBase(nn.Module):
    """The per-modality encoder/decoder pairs fc{m}_1 (in -> hidden) and
    fc{m}_2 (hidden -> in) shared by the dual models."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int,
                 p: float, gen: torch.Generator):
        super().__init__()
        self.fc1_1 = TorchDense(input_dim, hidden_dim, generator=gen)
        self.fc1_2 = TorchDense(hidden_dim, input_dim, generator=gen)
        self.fc2_1 = TorchDense(output_dim, hidden_dim, generator=gen)
        self.fc2_2 = TorchDense(hidden_dim, output_dim, generator=gen)
        self.p = p

    def _encode_decode(self, x0, x1, generator):
        e1, e2 = self.fc1_1(x0), self.fc2_1(x1)
        r1 = self.fc1_2(_dropout(e1, self.p, self.training, generator))
        r2 = self.fc2_2(_dropout(e2, self.p, self.training, generator))
        return e1, e2, r1, r2


class SimpleDualModel(_DualBase):
    """Dual AE with a conv bridge (utilities.py:301-333)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 10,
                 p: float = 0.6, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(input_dim, output_dim, hidden_dim, p, gen)
        self.conv = TorchDense(hidden_dim, hidden_dim, generator=gen)

    def forward(self, x0, x1, generator=None):
        e1, e2, r1, r2 = self._encode_decode(x0, x1, generator)
        return r1, r2, self.conv(e1), e2

    def last_forward(self, x0):
        return self.fc2_2(self.conv(self.fc1_1(x0)))

    @staticmethod
    def loss(logits, y0, y1):
        return (_mse(logits[0], y0) + _mse(logits[1], y1)
                + _mse(logits[2], logits[3].detach()))


class SimpleCommonDualModel(_DualBase):
    """Dual AE with a shared latent MSE tie (utilities.py:336-366)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 10,
                 p: float = 0.6, seed: int = 0):
        super().__init__(input_dim, output_dim, hidden_dim, p,
                         torch.Generator().manual_seed(seed))

    def forward(self, x0, x1, generator=None):
        e1, e2, r1, r2 = self._encode_decode(x0, x1, generator)
        return r1, r2, e1, e2

    def last_forward(self, x0):
        return self.fc2_2(self.fc1_1(x0))

    @staticmethod
    def loss(logits, y0, y1):
        return (_mse(logits[0], y0) + _mse(logits[1], y1)
                + _mse(logits[2], logits[3]))


class BABELMini(nn.Module):
    """Cross-decoding dual AE based on BABEL (utilities.py:369-399)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 16,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.fc1_1 = TorchDense(input_dim, hidden_dim, generator=gen)
        self.fc2_1 = TorchDense(output_dim, hidden_dim, generator=gen)
        self.fc1_2 = TorchDense(hidden_dim, input_dim, generator=gen)
        self.fc2_2 = TorchDense(hidden_dim, output_dim, generator=gen)

    def forward(self, x0, x1, generator=None):
        e1, e2 = self.fc1_1(x0), self.fc2_1(x1)
        return self.fc1_2(e1), self.fc2_2(e2), self.fc2_2(e1), self.fc1_2(e2)

    @staticmethod
    def loss(logits, y0, y1):
        return (_mse(logits[0], y0) + _mse(logits[1], y1)
                + _mse(logits[2], y1) + _mse(logits[3], y0))


class AdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay) over a list of
    parameters: the decay reads each parameter before the step, as optax's
    add_decayed_weights does, and the Adam part is `adam_update`."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            p.mul_(1.0 - self.lr * self.weight_decay)
            adam_update(p, g, mu, nu, self.count, self.lr, self.b1, self.b2,
                        self.eps)


def train_step(model: SimpleCommonDualModel, opt: AdamW, xb, yb,
               generator=None) -> torch.Tensor:
    """One AdamW step of `model` on the batch (xb, yb); returns the loss."""
    loss = SimpleCommonDualModel.loss(model(xb, yb, generator), xb, yb)
    opt.step(torch.autograd.grad(loss, opt.params))
    return loss.detach()


def predict_nn(source, target, val=None, epochs: int = 200,
               batch_size: int = 32, seed: int = 0,
               device=None) -> np.ndarray:
    """Train SimpleCommonDualModel on (source, target); predict target from
    source (or `val`) through `last_forward`. AdamW at 1e-3, MSE,
    max(n // batch_size, 1) random batches per epoch, each drawn without
    replacement."""
    device = resolve_device(device)
    xs = torch.as_tensor(np.asarray(source, np.float32), device=device)
    ys = torch.as_tensor(np.asarray(target, np.float32), device=device)
    model = SimpleCommonDualModel(xs.shape[1], ys.shape[1], seed=seed)
    model.to(device).train()
    opt = AdamW(model.parameters())
    gen = torch.Generator(device=device).manual_seed(seed)
    n = xs.shape[0]
    batches = max(int(n / batch_size), 1)
    for epoch in range(epochs):
        prog = math.floor(25 * (epoch + 1) / epochs) * '|'
        for _ in range(batches):
            idx = torch.randperm(n, generator=gen, device=device)[:batch_size]
            loss = train_step(model, opt, xs[idx], ys[idx], gen)
        print(f'{epoch + 1:>{len(str(epochs))}}/{epochs} [{prog:<25}]: '
              f'- Loss: {float(loss):.4f}', end='\r')
    print('\nDone!')

    model.eval()
    inp = (xs if val is None else
           torch.as_tensor(np.asarray(val, np.float32), device=device))
    with torch.no_grad():
        return model.last_forward(inp).cpu().numpy()
