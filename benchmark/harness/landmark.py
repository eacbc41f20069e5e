"""The landmark route's harness: two CSR arms with the same cells, as an
atlas reaches `fit_transform`, fitted through landmark F
(`corr_landmarks` in the configuration's kwargs). The fit keeps no
(N, N) matrix: F is the factors U = A_x F_L (N0, L0) and V = A_y
(N1, L1), and its solve runs at (L0, L1).

The arms (`make_host`), made on `device` from the seed in row blocks,
no whole arm dense at any time: a rank-`latent` latent z, each cell's
row on the sphere of radius sqrt(latent); each arm g = z W / sqrt(latent)
+ `noise` e with W and e standard Gaussian; each column cut at its
(1 - density) quantile tau, taken from one sample block of `SAMPLE`
rows drawn the same way (so each column's density holds in
expectation); kept where g > tau as log(1 + g - tau) ('continuous', as
log-normalized counts) or 1 ('binary', as peaks); then to the host as
scipy CSR. The interface is `harness/dense.py`'s.

This route's numbers (`reference_landmark.py`), against the fit's
landmark state (`F.landmarks`):

- `dist`: the fit's (L, L) landmark distance matrices against the
  reference's on the same landmark rows (euclidean, or geodesic from
  their kNN graph), as `harness/dense.py` judges them, undecided near-tie
  entries left out; NaN where a modality's picks fail the farthest-point
  test (`reference_landmark.fps_check`, on the reference's sketch from
  the fit's seed);
- `f`: ||F - F_ref||_F / ||F_ref||_F, F_ref = A_x' F_L' A_y'^T with F_L'
  the reference's prime-dual solve on its landmark distances and A' its
  weights from float64 distances of every cell to the landmark rows,
  from (L, L) Grams;
- `pca`: as `harness/dense.py`, the reference's subspace from subspace
  iteration on the CSR.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import scipy.sparse as sp
import torch

import check
import reference as ref
import reference_landmark as rl

# Rows of a generated block, and of the sample block whose per-column
# quantiles cut the columns
BLOCK = 8192
SAMPLE = 8192
# Feature columns sorted at a time for the quantiles
_SORT_COLS = 16384
# Neighbours within this relative distance of each other are a tie
# (`harness/dense.py`'s)
TIE = 1e-5
# A modality's top-r PCA subspace is compared where lambda_{r+1} /
# lambda_r of the reference is at most this (`harness/dense.py`'s)
GAP = 0.5


def _latent(n: int, latent: int, gen, device) -> torch.Tensor:
    z = torch.randn((n, latent), generator=gen, device=device)
    return z * (math.sqrt(latent) / z.norm(dim=1, keepdim=True))


def _thresholds(sample: torch.Tensor, density: float) -> torch.Tensor:
    """Each column's (1 - density) quantile, linear interpolation between
    order statistics (numpy's default), in column chunks."""
    n = sample.shape[0]
    pos = (1.0 - density) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    out = []
    for s in range(0, sample.shape[1], _SORT_COLS):
        o = torch.sort(sample[:, s:s + _SORT_COLS], dim=0).values
        out.append(o[lo] + frac * (o[hi] - o[lo]))
    return torch.cat(out)


def make_arm(z: torch.Tensor, f: int, density: float, kind: str,
             noise: float, gen, device):
    """One arm as scipy CSR (float32 values, int32 indices), and the
    seconds spent bringing its blocks to the host."""
    n, latent = z.shape
    scale = 1.0 / math.sqrt(latent)
    w = torch.randn((latent, f), generator=gen, device=device) * scale
    sample = _latent(SAMPLE, latent, gen, device) @ w
    sample += noise * torch.randn((SAMPLE, f), generator=gen, device=device)
    tau = _thresholds(sample, density)
    del sample
    indptr, indices, data = [np.zeros(1, np.int64)], [], []
    copy_s, nnz = 0.0, 0
    for s in range(0, n, BLOCK):
        e = min(s + BLOCK, n)
        g = z[s:e] @ w
        g += noise * torch.randn((e - s, f), generator=gen, device=device)
        g -= tau
        if kind == 'binary':
            g = (g > 0).to(torch.float32)
        elif kind == 'continuous':
            g.clamp_(min=0.0).log1p_()
        else:
            raise ValueError(f'unknown arm kind {kind!r}')
        csr = g.to_sparse_csr()
        del g
        crow = csr.crow_indices()
        col = csr.col_indices().to(torch.int32)
        vals = csr.values()
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        indptr.append(crow[1:].cpu().numpy().astype(np.int64) + nnz)
        indices.append(col.cpu().numpy())
        data.append(vals.cpu().numpy())
        copy_s += time.perf_counter() - t
        nnz += int(col.shape[0])
        del csr, crow, col, vals
    indptr = np.concatenate(indptr)
    if nnz < 2 ** 31 - 1:
        indptr = indptr.astype(np.int32)
    x = sp.csr_matrix((np.concatenate(data), np.concatenate(indices),
                       indptr), shape=(n, f))
    return x, copy_s


def make_host(config: dict, seed: int, device):
    """The two CSR arms made on `device` from the seed, block by block."""
    device = torch.device(device)
    t = time.perf_counter()
    shapes = config['shapes']
    n = int(shapes[0][0])
    if any(int(s[0]) != n for s in shapes):
        raise ValueError(f'the arms need the same cells: {shapes}')
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = _latent(n, int(config['latent']), gen, device)
    host, copy_s = [], 0.0
    for (_, f), density, kind in zip(shapes, config['density'],
                                     config['kinds']):
        x, c = make_arm(z, int(f), float(density), kind,
                        float(config['noise']), gen, device)
        host.append(x)
        copy_s += c
    del z
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return host, {'data_s': time.perf_counter() - t - copy_s,
                  'host_copy_s': copy_s}


def produced(jm) -> dict:
    """The factors of F and what the landmark route solved: the picks
    sorted and in order, the landmark distance matrices and F_L. A
    program whose F keeps no `landmarks` fails here."""
    F = jm.match_result[0]
    st = F.landmarks
    return {'F_factors': [F.u, F.v],
            'picks': [torch.as_tensor(p) for p in st.picks],
            'order': [torch.as_tensor(p) for p in st.order],
            'landmark_dist': [torch.as_tensor(d) for d in st.dist],
            'F_L': st.f_l}


def solve(jm, config: dict, kwargs: dict):
    """(min(L, N0), min(L, N1)), float32: the landmark solve's state."""
    L = int(kwargs['corr_landmarks'])
    n0, n1 = jm.row
    return (min(L, n0), min(L, n1)), 'float32'


class Reference(check.ModelReference):
    """The reference's landmark stages and PCA subspaces for one pair of
    CSR arms, and its training on a fit's inputs; each stage
    ('selection', 'distances', 'solver', 'weights', 'pca', 'model') in
    the precision the configuration states, or with `control`, one
    below. The stages after the selection start from a fit's picks, and
    are kept for the next fit with the same picks (the fits of a run
    share their seed)."""

    def __init__(self, host, config: dict, traffic: dict, device,
                 control: bool = False):
        super().__init__(config, traffic, device, control)
        self.host = host
        self.rank = int(config['latent'])
        self.mode = traffic['kwargs'].get('distance_mode', 'geodesic')
        if self.mode not in ('geodesic', 'euclidean', 'l2'):
            raise ValueError(f'no reference for distance_mode {self.mode!r}')
        self.basis, self.gaps = [], []
        for x in host:
            b, w = rl.pca_basis(x, min(self.rank, *x.shape), self.device,
                                ref.rounding(self.rnd['pca']))
            self.basis.append(b)
            r = b.shape[1]
            self.gaps.append(float(w[r] / w[r - 1]) if len(w) > r else 0.0)
            gc.collect()
        self._sketches = None       # (seed, the sketch rows a modality)
        self._stages = None         # (seed, picks, the stages)
        self._seed = None

    # ---------------------------------------------------------- stages
    def _draws(self, seed: int):
        return rl.draws(seed, [x.shape for x in self.host])

    def sketches(self, seed: int) -> list:
        """The rows FPS runs on, a modality, from the seed's draws."""
        if self._sketches is None or self._sketches[0] != seed:
            self._sketches = None
            rnd = ref.rounding(self.rnd['selection'])
            self._sketches = (seed, [
                rl.sketch(x, proj, self.device, rnd)
                for x, (_, proj) in zip(self.host, self._draws(seed))])
        return self._sketches[1]

    def stages(self, seed: int, picks) -> dict:
        """The landmark distances, F_L, weights and factors from sorted
        `picks` (a modality each)."""
        key = tuple(tuple(int(i) for i in np.asarray(p)) for p in picks)
        if self._stages is not None and self._stages[:2] == (seed, key):
            return self._stages[2]
        self._stages = None
        kw = self.kwargs
        rnd = self.rnd
        dist, undecided, a = [], [], []
        for x, p in zip(self.host, key):
            rows = np.asarray(x[list(p)].toarray(), np.float32)
            g = ref.gram(rows, self.device, ref.rounding(rnd['distances']))
            d, u = ref.euclidean(g), None
            del g
            if self.mode == 'geodesic':
                d, u = rl.geodesic(d, kmax=int(kw.get('kmax', 40)), tie=TIE)
            dist.append(d)
            undecided.append(u)
            a.append(rl.weights(x, rows, int(kw.get('corr_landmark_k', 8)),
                                self.device, ref.rounding(rnd['weights'])))
            gc.collect()
        f_l = ref.prime_dual(
            dist[0], dist[1], self.host[0].shape[1], self.host[1].shape[1],
            int(kw['epoch_pd']), rho=float(kw.get('rho', 10.0)),
            epsilon=float(kw.get('epsilon', 1e-3)),
            delay=int(kw.get('delay', 0)),
            rnd=ref.rounding(rnd['solver']))
        out = {'dist': dist, 'undecided': undecided, 'F_L': f_l,
               'factors': [a[0] @ f_l.double(), a[1]]}
        del a
        self._stages = (seed, key, out)
        return out

    def fps(self, out: dict) -> list:
        """`reference_landmark.fps_check` of each modality's pick order."""
        seed = int(out['manual_seed'])
        return [rl.fps_check(s, o, first)
                for s, o, (first, _) in zip(self.sketches(seed), out['order'],
                                            self._draws(seed))]

    # --------------------------------------------------------- numbers
    def numbers(self, out: dict, device) -> dict:
        """`dist`, `f` and `pca` of one fit; `out['span']`, where given,
        holds the columns whose span `pca` judges (the first columns of
        the training inputs T otherwise)."""
        seed = int(out['manual_seed'])
        st = self.stages(seed, out['picks'])
        fps_ok = all(c['ok'] for c in self.fps(out))
        dist = (max(ref.rel_fro(torch.as_tensor(d), w, u)
                    for d, w, u in zip(out['landmark_dist'], st['dist'],
                                       st['undecided']))
                if fps_ok else math.nan)
        f = rl.lowrank_gap(*out['F_factors'], *st['factors'])
        span = out.get('span') or out['T']
        pca = [ref.subspace_sine(
                   b, torch.as_tensor(t).to(device)[:, :b.shape[1]])
               for b, t, gap in zip(self.basis, span, self.gaps)
               if gap <= GAP]
        return {'dist': dist, 'f': f, 'pca': max(pca) if pca else math.nan}

    def training_f(self, out: dict):
        """U V^T on the device in float32: the one dense F, for the fit
        whose training is compared (its seed kept for `own`)."""
        self._seed = int(out['manual_seed'])
        u, v = (torch.as_tensor(t).to(self.device).float()
                for t in out['F_factors'])
        return u @ v.T

    def own(self) -> dict:
        """The reference's own stages in the program's place (the
        control's outputs): its FPS picks on its sketch, from the seed of
        the last `training_f`, and the stages and PCA subspaces after
        them."""
        seed = self._seed
        order = [rl.fps(s, first, min(int(self.kwargs['corr_landmarks']),
                                      s.shape[0]))
                 for s, (first, _) in zip(self.sketches(seed),
                                          self._draws(seed))]
        picks = [np.sort(o) for o in order]
        st = self.stages(seed, picks)
        return {'picks': picks, 'order': order,
                'landmark_dist': st['dist'], 'F_L': st['F_L'],
                'F_factors': st['factors'], 'span': self.basis}

    def detail(self, out: dict, device) -> dict:
        """Per modality and per norm, for the look behind a reading."""
        seed = int(out['manual_seed'])
        st = self.stages(seed, out['picks'])
        return {
            'fps': self.fps(out),
            'dist_max_rel': [ref.max_rel(torch.as_tensor(d).to(device), w)
                             for d, w in zip(out['landmark_dist'],
                                             st['dist'])],
            'undecided': [0 if u is None else int(u.sum())
                          for u in st['undecided']],
            'f_l_rel_fro': ref.rel_fro(torch.as_tensor(out['F_L']),
                                       st['F_L']),
            'v_rel_fro': ref.rel_fro(torch.as_tensor(out['F_factors'][1]),
                                     st['factors'][1]),
            'pca': [ref.subspace_sine(b, torch.as_tensor(t).to(device)
                                      [:, :b.shape[1]])
                    for b, t in zip(self.basis, out['T'])],
            'gap': [float(g) for g in self.gaps],
        }
