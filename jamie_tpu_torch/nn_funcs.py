"""Graph utilities.

Reference parity: `connect_graph` of jamie/nn_funcs.py:63-84, as
`jamie_tpu/nn_funcs.py:24-42` implements it (host numpy + scipy). The rest
of that module (kNN affinities, legacy losses) is ROADMAP.md item 13.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse.csgraph import connected_components


def connect_graph(adj: np.ndarray, weights: np.ndarray = None) -> np.ndarray:
    """Bridge disconnected components of `adj` into one.

    Components are chained in label order: each consecutive pair (c, c+1)
    gains one symmetric edge at the cheapest cross entry of `weights`
    (defaults to `adj` itself). Returns a copy.
    """
    adj = np.array(adj)
    weights = adj if weights is None else np.asarray(weights)
    n_comp, labels = connected_components(adj, directed=False)
    groups = [np.flatnonzero(labels == c) for c in range(n_comp)]
    for a, b in zip(groups[:-1], groups[1:]):
        block = weights[np.ix_(a, b)]
        flat = int(np.argmin(block))
        i, j = a[flat // len(b)], b[flat % len(b)]
        adj[i, j] = adj[j, i] = block.flat[flat]
    return adj
