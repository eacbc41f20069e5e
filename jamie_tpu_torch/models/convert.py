"""Carry CoupledVAE variables between jamie_tpu (flax) and this package.

flax names, as `CoupledVAE.init` creates them in jamie_tpu:

    params/enc{i}_b{j}/TorchDense_0/{kernel,bias}
    params/enc{i}_b{j}/BatchNorm_0/{scale,bias}
    params/fc_mu{i}/{kernel,bias}, params/fc_var{i}/{kernel,bias}
    params/dec{i}_b{j}/TorchDense_0/..., params/dec{i}_b{j}/BatchNorm_0/...
    params/dec{i}_out/{kernel,bias}
    params/sigma
    batch_stats/{enc,dec}{i}_b{j}/BatchNorm_0/{mean,var}

flax kernels are (in, out) and torch weights (out, in); both packages keep
BatchNorm momentum 0.9 on the running value, so the stats carry as they are.
Arrays cross as numpy dicts in flax's nesting.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .coupled_vae import CoupledVAE, FlaxBatchNorm, TorchDense


def _dense_pair(dense: TorchDense):
    return {'kernel': (dense.weight, True), 'bias': (dense.bias, False)}


def _slots(model: CoupledVAE):
    """(params slots, batch_stats slots): {flax path: (tensor, transpose)}."""
    params, stats = {}, {}
    for name, layer in model.layers.items():
        if isinstance(layer, TorchDense):
            for k, v in _dense_pair(layer).items():
                params[(name, k)] = v
            continue
        for k, v in _dense_pair(layer.dense).items():
            params[(name, 'TorchDense_0', k)] = v
        bn: FlaxBatchNorm = layer.bn
        params[(name, 'BatchNorm_0', 'scale')] = (bn.weight, False)
        params[(name, 'BatchNorm_0', 'bias')] = (bn.bias, False)
        stats[(name, 'BatchNorm_0', 'mean')] = (bn.running_mean, False)
        stats[(name, 'BatchNorm_0', 'var')] = (bn.running_var, False)
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


def load_flax_variables(model: CoupledVAE, params: dict,
                        batch_stats: dict) -> CoupledVAE:
    """Copy flax-nested numpy `params` / `batch_stats` into `model` in
    place (shapes are checked); returns the model."""
    p_slots, s_slots = _slots(model)
    with torch.no_grad():
        for tree, slots in ((params, p_slots), (batch_stats, s_slots)):
            for path, (tensor, transpose) in slots.items():
                arr = _get(tree, path)
                arr = arr.T if transpose else arr
                if tuple(arr.shape) != tuple(tensor.shape):
                    raise ValueError(
                        f'{"/".join(path)}: shape {arr.shape} does not fit '
                        f'{tuple(tensor.shape)}')
                tensor.copy_(torch.from_numpy(np.array(arr, np.float32)))
    return model


def to_flax_variables(model: CoupledVAE) -> Tuple[Dict, Dict]:
    """(params, batch_stats) as flax-nested dicts of float32 numpy arrays."""
    p_slots, s_slots = _slots(model)
    out = ({}, {})
    for tree, slots in zip(out, (p_slots, s_slots)):
        for path, (tensor, transpose) in slots.items():
            arr = tensor.detach().cpu().numpy().astype(np.float32)
            _set(tree, path, np.ascontiguousarray(arr.T if transpose else arr))
    return out
