"""The dense route's harness: two dense float32 arms with the same cells,
as the published notebooks hand them to `fit_transform`. The fit keeps
its (N0, N0) and (N1, N1) distances and a dense (N0, N1) F, and its
prime-dual solve runs at (N0, N1).

A harness module (`harness/<name>.py`, named by a configuration's
`harness` key; `manifest.harness`) provides:

- `make_host(config, seed, device)`: the modalities as a user hands them
  to `fit_transform` (numpy arrays or scipy CSR matrices), made from the
  seed alone, and the set-up seconds `{'data_s': making them,
  'host_copy_s': bringing them to the host}`;
- `produced(jm)`: the part of what the fit `jm` produced that only its
  route makes, a dict of tensors or arrays (or lists of them), which the
  run copies to the host beside what every route produces (`run.one_fit`);
- `solve(jm, config, kwargs)`: the (n0, n1) that K1 and the prime-dual
  solve ran at, and the solver state dtype they ran in;
- `Reference(host, config, traffic, device, control=False)`: a
  `check.ModelReference` with the route's own stages in the precisions
  the configuration states (one below with `control`). Its
  `numbers(out, device)` gives `dist`, `f` and `pca`, NaN for a number
  it does not judge (the cell's limit for it is then null); its
  `training_f(out)` gives the dense F the training reference takes.
  `control.py` also asks it for `own()`, its stages' outputs in the
  program's place, and `detail(out, device)`.

This route's numbers:

- `dist`: the fit's distance matrices (euclidean, or geodesic from the kNN
  graph), ||D - D_ref||_F / ||D_ref||_F, the larger of the two; geodesic
  entries that a near-tie at a row's last kNN neighbour (within `TIE`,
  relative) leaves undecided are left out (PERF.md);
- `f`: the correspondence F after the cell's iterations, ||F - F_ref||_F /
  ||F_ref||_F (its largest entry gap swings with Adam's sign-like steps
  wherever a gradient crosses zero; PERF.md);
- `pca`: the sine of the largest principal angle between the span of the
  first `latent` columns the fit trained on and the reference's top
  `latent` left singular subspace of the centred rows, over the
  modalities where that subspace is well defined (the next Ritz value at
  most `GAP` of the last one; PERF.md).
"""

from __future__ import annotations

import gc
import math
import time

import torch

import check
import datagen
import reference as ref

# Neighbours within this relative distance of each other are a tie that
# rounding may break either way: 20 times the port's float32 distance
# error, a twentieth of what TF32 rounding moves them by
TIE = 1e-5
# A modality's top-r PCA subspace is compared where lambda_{r+1} / lambda_r
# of the reference is at most this
GAP = 0.5


def make_host(config: dict, seed: int, device):
    """The pair made on `device` from the seed (`datagen.make_pair`) and
    copied to host numpy once, as a user's data arrive."""
    device = torch.device(device)
    t = time.perf_counter()
    made = datagen.make_pair(config, seed, device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    data_s = time.perf_counter() - t
    t = time.perf_counter()
    host = [x.cpu().numpy() for x in made]
    del made
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return host, {'data_s': data_s, 'host_copy_s': time.perf_counter() - t}


def produced(jm) -> dict:
    """The fit's two distance matrices and its dense F."""
    return {'dist': list(jm.dist), 'F': jm.match_result[0]}


def solve(jm, config: dict, kwargs: dict):
    """(N0, N1), and the state dtype the estimator resolves for them."""
    from jamie_tpu_torch import estimator
    n0, n1 = jm.row
    return (n0, n1), jm._resolved_state_dtype(
        estimator.dense_entries(n0, n1, 'float32'))


class Reference(check.ModelReference):
    """The reference's distances, subspaces and F for one pair of raw
    modalities, and its training on a fit's inputs; each stage
    ('distances', 'pca', 'solver', 'model') in the precision the
    configuration states, or with `control`, one below."""

    def __init__(self, host, config: dict, traffic: dict, device,
                 control: bool = False):
        super().__init__(config, traffic, device, control)
        rnd = self.rnd
        self.rank = int(config['latent'])
        mode = traffic['kwargs'].get('distance_mode', 'geodesic')
        self.dist, self.undecided, self.basis, self.gaps = [], [], [], []
        for x in host:
            g = ref.gram(x, device, ref.rounding(rnd['distances']))
            d, undecided = ref.euclidean(g), None
            if mode == 'geodesic':
                d, undecided = ref.geodesic(
                    d, kmax=int(traffic['kwargs'].get('kmax', 40)), tie=TIE)
            elif mode not in ('euclidean', 'l2'):
                raise ValueError(f'no reference for distance_mode {mode!r}')
            self.dist.append(d)
            self.undecided.append(undecided)
            if rnd['pca'] != rnd['distances']:
                del g
                g = ref.gram(x, device, ref.rounding(rnd['pca']))
            basis, w = ref.pca_subspace(g, min(self.rank, *x.shape))
            self.basis.append(basis)
            # the spectral gap that makes the top subspace well defined
            r = basis.shape[1]
            self.gaps.append(float(w[r] / w[r - 1]) if len(w) > r else 0.0)
            del g
            gc.collect()
        kw = self.kwargs
        self.F = ref.prime_dual(
            self.dist[0], self.dist[1], host[0].shape[1], host[1].shape[1],
            int(kw['epoch_pd']), rho=float(kw.get('rho', 10.0)),
            epsilon=float(kw.get('epsilon', 1e-3)),
            delay=int(kw.get('delay', 0)),
            rnd=ref.rounding(rnd['solver']))

    def numbers(self, out: dict, device) -> dict:
        """`dist`, `f` and `pca` of one fit; `out['span']`, where given,
        holds the columns whose span `pca` judges (the first columns of
        the training inputs T otherwise)."""
        dist = max(ref.rel_fro(torch.as_tensor(d), w, u)
                   for d, w, u in zip(out['dist'], self.dist,
                                      self.undecided))
        f = ref.rel_fro(torch.as_tensor(out['F']), self.F)
        span = out.get('span') or out['T']
        pca = [ref.subspace_sine(
                   b, torch.as_tensor(t).to(device)[:, :b.shape[1]])
               for b, t, gap in zip(self.basis, span, self.gaps)
               if gap <= GAP]
        return {'dist': dist, 'f': f, 'pca': max(pca) if pca else math.nan}

    def own(self) -> dict:
        """The reference's distances, F and PCA subspaces in the program's
        place (the control's outputs)."""
        return {'dist': self.dist, 'F': self.F, 'span': self.basis}

    def detail(self, out: dict, device) -> dict:
        """Per modality and per norm, for the look behind a reading."""
        F = torch.as_tensor(out['F']).to(device)
        return {
            'dist_max_rel': [ref.max_rel(torch.as_tensor(d).to(device), w)
                             for d, w in zip(out['dist'], self.dist)],
            'undecided': [0 if u is None else int(u.sum())
                          for u in self.undecided],
            'f_max_rel': ref.max_rel(F, self.F),
            'f_stats': [float(self.F.max()), float(self.F.mean()),
                        float(self.F.min()), float(F.max())],
            'pca': [ref.subspace_sine(b, t.to(device)[:, :b.shape[1]])
                    for b, t in zip(self.basis, out['T'])],
            'gap': [float(g) for g in self.gaps],
        }
