"""Hard pair extraction from the soft correspondence F.

Reference parity: `jamie_tpu/solvers/assignment.py:17-20`, itself
`linear_sum_assignment(max(F) - F)` in fit_transform (jamie/jamie.py:
175-182). The Hungarian assignment is a sequential O(N^3) algorithm that
stays on the host in scipy; F is fetched from the device once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def hungarian_pairs(F) -> Tuple[np.ndarray, np.ndarray]:
    """(row indices, column indices) of the assignment maximising the sum
    of F over the pairs; F is a host array or a tensor on any device."""
    F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
    return linear_sum_assignment(np.max(F) - F)
