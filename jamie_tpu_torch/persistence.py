"""Checkpointing: params + batch stats + preprocessing as plain arrays.

The same .npz layout as `jamie_tpu/persistence.py:21-72` — flat
`params/...`, `batch_stats/...` and `pre{i}/...` keys under flax's names,
plus a JSON `__header__` — so a checkpoint written by either package loads
in the other. The model's variables cross through `models/convert.py`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np


def _flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in (tree or {}).items():
        if isinstance(v, dict):
            out.update(_flatten(v, f'{prefix}/{k}'))
        else:
            out[f'{prefix}/{k}'] = np.asarray(v)
    return out


def _unflatten(arrays: Dict[str, np.ndarray], prefix: str) -> Dict:
    tree: Dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + '/'):
            continue
        *path, leaf = key[len(prefix) + 1:].split('/')
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_checkpoint(path: str, params: Any, batch_stats: Any,
                    preprocessors: Tuple, header: Dict[str, Any]) -> None:
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(_flatten(params, 'params'))
    arrays.update(_flatten(batch_stats, 'batch_stats'))
    for i, pre in enumerate(preprocessors):
        for k, v in pre.to_dict().items():
            arrays[f'pre{i}/{k}'] = np.asarray(v)
    arrays['__header__'] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    with open(path, 'wb') as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str, device=None):
    """(params, batch_stats, preprocessors, header); the preprocessors' PCA
    state goes to `device`."""
    from .preprocess import Preprocessor
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays.pop('__header__').tolist()).decode())
    params = _unflatten(arrays, 'params')
    batch_stats = _unflatten(arrays, 'batch_stats')
    pres = []
    i = 0
    while any(k.startswith(f'pre{i}/') for k in arrays):
        d = {k[len(f'pre{i}/'):]: v for k, v in arrays.items()
             if k.startswith(f'pre{i}/')}
        pres.append(Preprocessor.from_dict(d, device=device))
        i += 1
    return params, batch_stats, tuple(pres), header
