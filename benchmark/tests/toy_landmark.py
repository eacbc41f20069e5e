"""A harness module for a test (copied to `harness/toy_landmark.py` of a
tree's copy): scipy CSR arms and the landmark F, at a size where F can be
made dense.

The arms: a rank-`latent` Gaussian latent z, each arm z W + noise with
all but each column's top `density` share set to 0, in CSR. The fit
takes the landmark route (`corr_landmarks` in the configuration's
kwargs), so it keeps no distances and returns F as factors; `produced`
records the factors and F made dense, which the training reference
takes. Its `Reference` judges `pca` only (`dist` and `f` NaN: the cell's
limits for them are null)."""

from __future__ import annotations

import math
import time

import numpy as np
import scipy.sparse as sp
import torch

import check
import reference as ref


def make_host(config: dict, seed: int, device):
    t = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = int(config['shapes'][0][0])
    latent = int(config['latent'])
    z = torch.randn((n, latent), generator=gen, device=device)
    host = []
    for (_, f), density in zip(config['shapes'], config['density']):
        x = z @ torch.randn((latent, int(f)), generator=gen, device=device)
        x += float(config['noise']) * torch.randn(
            (n, int(f)), generator=gen, device=device)
        tau = torch.quantile(x, 1.0 - float(density), dim=0)
        x = torch.where(x > tau, x - tau, torch.zeros_like(x))
        host.append(sp.csr_matrix(x.cpu().numpy()))
    return host, {'data_s': time.perf_counter() - t, 'host_copy_s': 0.0}


def produced(jm) -> dict:
    F = jm.match_result[0]
    return {'F_factors': [F.u, F.v], 'F': F.to_dense()}


def solve(jm, config: dict, kwargs: dict):
    L = int(kwargs['corr_landmarks'])
    n0, n1 = jm.row
    return (min(L, n0), min(L, n1)), 'float32'


class Reference(check.ModelReference):
    """The top `latent` subspace of each arm's centred rows."""

    def __init__(self, host, config: dict, traffic: dict, device,
                 control: bool = False):
        super().__init__(config, traffic, device, control)
        self.basis = []
        for x in host:
            g = ref.gram(np.asarray(x.toarray(), np.float32), device,
                         ref.rounding(self.rnd['pca']))
            self.basis.append(ref.pca_subspace(
                g, min(int(config['latent']), *x.shape))[0])

    def numbers(self, out: dict, device) -> dict:
        pca = max(ref.subspace_sine(
            b, torch.as_tensor(t).to(device)[:, :b.shape[1]])
            for b, t in zip(self.basis, out['T']))
        return {'dist': math.nan, 'f': math.nan, 'pca': pca}
