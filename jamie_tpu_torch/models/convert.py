"""Carry model variables between jamie_tpu (flax) and this package.

flax names, as `CoupledVAE.init` creates them in jamie_tpu:

    params/enc{i}_b{j}/TorchDense_0/{kernel,bias}
    params/enc{i}_b{j}/BatchNorm_0/{scale,bias}
    params/fc_mu{i}/{kernel,bias}, params/fc_var{i}/{kernel,bias}
    params/dec{i}_b{j}/TorchDense_0/..., params/dec{i}_b{j}/BatchNorm_0/...
    params/dec{i}_out/{kernel,bias}
    params/sigma
    batch_stats/{enc,dec}{i}_b{j}/BatchNorm_0/{mean,var}

and for the small models (`models/simple.py`, `models/baselines.py`), whose
layers are children named as flax names them:

    params/{fc1,fc2,fc1_1,fc1_2,fc2_1,fc2_2,conv,enc{i},dec{i}}/{kernel,bias}
    params/{enc,dec}{i}_bn/{scale,bias}, batch_stats/{enc,dec}{i}_bn/{mean,var}

flax kernels are (in, out) and torch weights (out, in); both packages keep
BatchNorm momentum 0.9 on the running value, so the stats carry as they are.
Arrays cross as numpy dicts in flax's nesting.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .coupled_vae import CoupledVAE, FlaxBatchNorm, TorchDense


def _slots(model: nn.Module):
    """(params slots, batch_stats slots): {flax path: (tensor, transpose)}."""
    params, stats = {}, {}

    def dense(path, layer: TorchDense):
        params[path + ('kernel',)] = (layer.weight, True)
        params[path + ('bias',)] = (layer.bias, False)

    def batch_norm(path, bn: FlaxBatchNorm):
        params[path + ('scale',)] = (bn.weight, False)
        params[path + ('bias',)] = (bn.bias, False)
        stats[path + ('mean',)] = (bn.running_mean, False)
        stats[path + ('var',)] = (bn.running_var, False)

    is_vae = isinstance(model, CoupledVAE)
    for name, layer in (model.layers.items() if is_vae
                        else model.named_children()):
        if isinstance(layer, TorchDense):
            dense((name,), layer)
        elif isinstance(layer, FlaxBatchNorm):
            batch_norm((name,), layer)
        else:   # a CoupledVAE block: TorchDense_0 + BatchNorm_0
            dense((name, 'TorchDense_0'), layer.dense)
            batch_norm((name, 'BatchNorm_0'), layer.bn)
    if is_vae:
        params[('sigma',)] = (model.sigma, False)
    return params, stats


def _get(tree: dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def load_flax_variables(model: nn.Module, params: dict,
                        batch_stats: Optional[dict] = None) -> nn.Module:
    """Copy flax-nested numpy `params` / `batch_stats` into `model` in
    place (shapes are checked); returns the model. `batch_stats` may be
    omitted for a model without BatchNorm."""
    p_slots, s_slots = _slots(model)
    with torch.no_grad():
        for tree, slots in ((params, p_slots), (batch_stats or {}, s_slots)):
            for path, (tensor, transpose) in slots.items():
                arr = _get(tree, path)
                arr = arr.T if transpose else arr
                if tuple(arr.shape) != tuple(tensor.shape):
                    raise ValueError(
                        f'{"/".join(path)}: shape {arr.shape} does not fit '
                        f'{tuple(tensor.shape)}')
                tensor.copy_(torch.from_numpy(np.array(arr, np.float32)))
    return model


def to_flax_variables(model: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) as flax-nested dicts of float32 numpy arrays."""
    p_slots, s_slots = _slots(model)
    out = ({}, {})
    for tree, slots in zip(out, (p_slots, s_slots)):
        for path, (tensor, transpose) in slots.items():
            arr = tensor.detach().cpu().numpy().astype(np.float32)
            _set(tree, path, np.ascontiguousarray(arr.T if transpose else arr))
    return out
