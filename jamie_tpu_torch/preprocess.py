"""Invertible preprocessing: PCA projection + fit-sample standardization.

Reference parity: `jamie_tpu/preprocess.py` — `PCA` with the `_pca_fit`
routing (:276-323) between the exact Gram/covariance eigh route
(`_pca_fit_direct`, :326-345) and the Halko randomized route
(`_pca_fit_randomized`, :46-73) past `_RANDOMIZED_THRESHOLD`; the
`_component_signs` convention (:267-273); and `Preprocessor` (:506-680),
the reference's `preclass` (jamie/utilities.py:654-678): PCA to `pca_dim`
then scalar standardization, or per-feature standardization without PCA,
NaN -> 0, fully invertible, with the same `to_dict` keys so checkpoints
cross between the packages.

The PCA linear algebra runs on `device` (the card unless the caller asks
for another); the standardization runs on the host, as in jamie_tpu.

Not ported: the bf16-resident, column-streamed and row-streamed routes
past `_STREAM_THRESHOLD` (ROADMAP.md item 11), scipy-sparse inputs (item
11) and the t-SNE/UMAP preclass (item 12).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .core.dtypes import resolve_device
from .core.hostmat import as_f32_ndarray, is_scipy_sparse

# jamie_tpu's bf16-resident / streamed PCA threshold (preprocess.py:32)
_STREAM_THRESHOLD = 100_000_000

# Above this many cells (and with n_components <= min(n, f) // 4) the
# randomized range finder replaces the full eigh (preprocess.py:37)
_RANDOMIZED_THRESHOLD = 4096


def _pca_fit_randomized(X: torch.Tensor, n_components: int,
                        oversample: int = 10, power_iters: int = 2,
                        seed: int = 0):
    """Halko-style randomized PCA: tall matmuls plus a small eigh. Omega
    comes from a torch.Generator on X's device, so the sketch differs from
    jamie_tpu's (a jax key) while the subspace it finds agrees."""
    n, f = X.shape
    k = min(n_components + oversample, min(n, f))
    mean = X.mean(0)
    Xc = X - mean
    gen = torch.Generator(device=X.device).manual_seed(seed)
    omega = torch.randn((f, k), generator=gen, device=X.device,
                        dtype=torch.float32)
    Q, _ = torch.linalg.qr(Xc @ omega)
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Xc @ (Xc.T @ Q))
    B = Q.T @ Xc                                   # (k, f)
    w, Ub = torch.linalg.eigh(B @ B.T)
    Ub = Ub.flip(1)[:, :n_components]
    s = torch.sqrt(torch.clamp(w.flip(0)[:n_components], min=1e-12))
    return mean, (Ub / s).T @ B                    # (n_components, f)


def _pca_fit_direct(X: torch.Tensor, n_components: int):
    """Exact PCA (Gram route for tall-feature matrices)."""
    n, f = X.shape
    mean = X.mean(0)
    Xc = X - mean
    if f > n:
        # Gram route: Xc Xc^T = U S^2 U^T; components = S^-1 U^T Xc
        w, U = torch.linalg.eigh(Xc @ Xc.T)        # ascending
        w = w.flip(0)[:n_components]
        U = U.flip(1)[:, :n_components]
        s = torch.sqrt(torch.clamp(w, min=1e-12))
        comps = (U / s).T @ Xc                     # (k, F)
    else:
        _, V = torch.linalg.eigh(Xc.T @ Xc)
        comps = V.flip(1)[:, :n_components].T
    return mean, comps


def _component_signs(comps: torch.Tensor) -> torch.Tensor:
    """sklearn svd_flip style: the largest-|.| entry of each component is
    made positive."""
    idx = torch.argmax(comps.abs(), dim=1)
    signs = torch.sign(comps[torch.arange(comps.shape[0]), idx])
    return torch.where(signs == 0, torch.ones_like(signs), signs)


def _pca_fit(X: torch.Tensor, n_components: int):
    """Return (mean, sign-fixed components[k, F]) by jamie_tpu's routing."""
    n, f = X.shape
    if (min(n, f) > _RANDOMIZED_THRESHOLD
            and n_components <= min(n, f) // 4):
        mean, comps = _pca_fit_randomized(X, n_components)
    else:
        mean, comps = _pca_fit_direct(X, n_components)
    return mean, comps * _component_signs(comps)[:, None]


def _check_dense(X, what: str):
    if is_scipy_sparse(X):
        raise NotImplementedError(
            f'sparse {what} is ROADMAP.md item 11 (sparse and atlas data '
            'inputs)')
    n, f = np.shape(X)
    if n * f > _STREAM_THRESHOLD:
        raise NotImplementedError(
            f'{what} of {n} x {f} is past the {_STREAM_THRESHOLD:,}-element '
            'streamed-PCA threshold: ROADMAP.md item 11')
    return as_f32_ndarray(X)


class PCA:
    """Minimal sklearn-compatible PCA whose linear algebra runs on
    `device`. `mean_` and `components_` are device tensors; transforms take
    and return host arrays."""

    def __init__(self, n_components: int, device=None):
        self.n_components = int(n_components)
        self.device = resolve_device(device)
        self.mean_: Optional[torch.Tensor] = None
        self.components_: Optional[torch.Tensor] = None

    def fit(self, X):
        X = _check_dense(X, 'PCA input')
        self.mean_, self.components_ = _pca_fit(
            torch.as_tensor(X, device=self.device), self.n_components)
        return self

    def transform(self, X) -> np.ndarray:
        X = _check_dense(X, 'PCA input')
        Xt = torch.as_tensor(X, device=self.device)
        return ((Xt - self.mean_) @ self.components_.T).cpu().numpy()

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)

    def inverse_transform(self, Y) -> np.ndarray:
        Yt = torch.as_tensor(np.asarray(Y, np.float32), device=self.device)
        return (Yt @ self.components_ + self.mean_).cpu().numpy()


class Preprocessor:
    """preclass-equivalent: [PCA ->] standardize by fit-sample stats.

    axis: None standardizes by the scalar mean/std of the whole transformed
    sample (the PCA path, jamie.py:453); 0 standardizes per feature (the
    no-PCA path, jamie.py:455,462-465).
    """

    def __init__(self, sample: Optional[np.ndarray] = None,
                 pca: Optional[PCA] = None, axis: Optional[int] = None):
        self.pca = pca
        self.axis = axis
        if sample is None:
            self.sample_mean = None
            self.sample_std = None
        else:
            sample = np.asarray(sample, np.float32)
            self.sample_mean = np.asarray(sample.mean(axis), np.float32)
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                self.sample_std = np.asarray(sample.std(axis), np.float32)

    @classmethod
    def fit(cls, data, pca_dim: Optional[int] = None, method: str = 'pca',
            device=None) -> 'Preprocessor':
        """Build the per-modality preprocessor as project_jamie does
        (jamie/jamie.py:436-465): PCA to pca_dim (clamped, with a warning)
        then scalar standardization; or per-feature standardization."""
        if method != 'pca':
            raise NotImplementedError(
                f"model_pca={method!r} is ROADMAP.md item 12; only 'pca' is "
                'ported')
        data = _check_dense(data, 'Preprocessor input')
        if pca_dim is not None:
            dim = int(pca_dim)
            if min(*data.shape) < dim:
                warnings.warn(
                    f'PCA dim must be lower than {min(*data.shape)}, found '
                    f'{dim}, adjusting to compensate.')
                dim = min(*data.shape)
            pca = PCA(n_components=dim, device=device)
            sample = pca.fit_transform(data)
            pre = cls(sample, pca=pca, axis=None)
            pre._fit_sample = sample
            return pre
        pre = cls(data, axis=0)
        pre._fit_sample = data
        return pre

    def _standardize(self, out) -> np.ndarray:
        out = np.array(out, np.float32)
        out = out - self.sample_mean
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            out = out / self.sample_std
        out[np.isnan(out)] = 0
        return out

    def transform_fit(self) -> np.ndarray:
        """Standardized transform of the data this preprocessor was fit on,
        from the cached fit sample (no second projection)."""
        return self._standardize(self._fit_sample)

    def transform(self, X) -> np.ndarray:
        out = _check_dense(X, 'Preprocessor input')
        if self.pca is not None:
            out = self.pca.transform(out)
        return self._standardize(out)

    def inverse_transform(self, X) -> np.ndarray:
        out = np.asarray(X, np.float32)
        out = out * self.sample_std
        out = out + self.sample_mean
        if self.pca is not None:
            out = self.pca.inverse_transform(out)
        return out

    # --- checkpointable state (same keys as jamie_tpu) ---
    def to_dict(self) -> dict:
        d = {
            'axis': -1 if self.axis is None else self.axis,
            'sample_mean': self.sample_mean,
            'sample_std': self.sample_std,
        }
        if self.pca is not None:
            d['pca_mean'] = self.pca.mean_.cpu().numpy()
            d['pca_components'] = self.pca.components_.cpu().numpy()
        return d

    @classmethod
    def from_dict(cls, d: dict, device=None) -> 'Preprocessor':
        if 'nle_embedding' in d:
            raise NotImplementedError(
                'a t-SNE/UMAP preclass is ROADMAP.md item 12')
        self = cls.__new__(cls)
        axis = int(d['axis'])
        self.axis = None if axis == -1 else axis
        self.sample_mean = np.asarray(d['sample_mean'])
        self.sample_std = np.asarray(d['sample_std'])
        if 'pca_components' in d:
            comps = np.asarray(d['pca_components'], np.float32)
            pca = PCA(n_components=comps.shape[0], device=device)
            pca.mean_ = torch.tensor(np.asarray(d['pca_mean'], np.float32),
                                     device=pca.device)
            pca.components_ = torch.tensor(comps, device=pca.device)
            self.pca = pca
        else:
            self.pca = None
        return self
