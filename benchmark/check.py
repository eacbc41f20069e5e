"""Whether the fits of a run are correct: what each fit produced against
the plain reference (`reference.py`), number by number, each against its
limit in `workloads/<cell>.json` (a limit of null: not compared there).

The numbers, each the worst over the run's fits:

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
  most `GAP` of the last one; PERF.md);
- `embed`: the embeddings the fit returned against the reference's mean
  head on the fit's final parameters and training inputs, max |E - E_ref|
  / max |E_ref|, the larger of the two;
- `loss`, `dtheta`, `nu`: the training, in one fit drawn from the seed,
  against the reference's training (`reference.train`) from the
  reference's own initialization, on that fit's training inputs and F,
  with the fit's batches and noise drawn as the model draws them:
  `loss` the relative gap of the first epoch's mean batch loss; `dtheta`
  and `nu`, by the worst leaf, the gap between the fit's and the
  reference's norm of the parameters' change over the fit and of Adam's
  second moment at its end (the gradients as the optimizer got them),
  over the larger of the reference leaf's norm and the median leaf's.
  Leaves whose first gradient in the reference is under `NOUGHT` of the
  median leaf's (the Linear biases that BatchNorm cancels) move by
  round-off alone and are left out;
- `foscttm`: FOSCTTM of the returned embeddings, by the reference.

The training reference takes the fit's PCA projections and F as its
inputs: those stages are judged by themselves (`pca`, `f`).
"""

from __future__ import annotations

import gc
import math
import random
import statistics

import torch

import reference as ref

NUMBERS = ('dist', 'f', 'pca', 'embed', 'loss', 'dtheta', 'nu', 'foscttm')
TRAINING = ('loss', 'dtheta', 'nu')
# Neighbours within this relative distance of each other are a tie that
# rounding may break either way: 20 times the port's float32 distance
# error, a twentieth of what TF32 rounding moves them by
TIE = 1e-5
# A modality's top-r PCA subspace is compared where lambda_{r+1} / lambda_r
# of the reference is at most this
GAP = 0.5
# Epochs whose mean loss `loss` compares: the first, before the round-off
# that Adam's sign-like steps amplify has grown (PERF.md)
LOSS_EPOCHS = 1
# A leaf whose first gradient is under this share of the median leaf's
# moves by round-off alone
NOUGHT = 1e-3


# The rounding of a stage's operands: at the precision the configuration
# states (`precision` in its file), and one below it for the control
STATED = {'float32': None, 'bfloat16': 'bf16'}
LOWER = {'float32': 'tf32', 'bfloat16': 'fp8'}


class Reference:
    """The reference's distances, subspaces and F for one pair of raw
    modalities, and its training on a fit's inputs; each stage
    ('distances', 'pca', 'solver', 'model') in the precision the
    configuration states, or with `control`, one below."""

    def __init__(self, host, config: dict, traffic: dict, device,
                 control: bool = False):
        ref.plain_matmuls()
        table = LOWER if control else STATED
        rnd = {stage: table[p] for stage, p in config['precision'].items()}
        self.config = config
        self.kwargs = dict(config['kwargs'], **traffic['kwargs'])
        self.device = torch.device(device)
        self.rnd = rnd
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
        self._trained = None

    def embed(self, out: dict, i: int, device) -> torch.Tensor:
        return ref.embed(out['params'], i, out['T'][i].to(device),
                         ref.rounding(self.rnd['model']))

    def train(self, T, F, seed: int) -> dict:
        """The reference's training on the fit's training rows T and F,
        from its own initialization (kept for the next call with the same
        seed: the fits of a run share their inputs' seed)."""
        if self._trained is not None and self._trained[0] == seed:
            return self._trained[1]
        self._trained = None
        kw = self.kwargs
        data = [torch.as_tensor(t).to(self.device).float() for t in T]
        p0, s0 = ref.init_model([d.shape[1] for d in data],
                                int(kw['output_dim']), seed)
        pf = kw.get('PF_Ratio')
        done = ref.train(
            p0, s0, data, torch.as_tensor(F).to(self.device).float(),
            epochs=int(kw['epoch_DNN']), batch=int(kw['batch_size']),
            lr=float(kw.get('model_lr', 1e-3)), seed=seed,
            min_epochs=int(kw.get('min_epochs', 2500)),
            weights=kw.get('loss_weights') or (1.0,) * 4,
            pf_ratio=1.0 if pf is None else float(pf),
            rnd=ref.rounding(self.rnd['model']))
        done['init'] = {k: v.to(self.device) for k, v in p0.items()}
        del data
        self._trained = (seed, done)
        return done


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(torch.as_tensor(t).double()))


def leaf_gaps(got: dict, want: dict, keep) -> dict:
    """Each leaf's | |got| - |want| | over the larger of |want| and the
    median leaf's |want| (2-norms), over the leaves `keep`."""
    norms = {k: _norm(want[k]) for k in keep}
    med = statistics.median(norms.values())
    return {k: abs(_norm(got[k]) - norms[k]) / max(norms[k], med)
            for k in keep}


def leaf_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(got, want, keep).values())


def moving_leaves(grad1: dict) -> list:
    """The leaves whose first gradient is at least `NOUGHT` of the median
    leaf's."""
    norms = {k: _norm(v) for k, v in grad1.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= NOUGHT * med]


def training_numbers(out: dict, want: Reference, seed: int) -> dict:
    """`loss`, `dtheta`, `nu` of one fit against the reference's training
    on the same inputs."""
    r = want.train(out['T'], out['F'], seed)
    keep = moving_leaves(r['grad1'])
    k = min(LOSS_EPOCHS, len(r['epoch_losses']))
    got_l = list(out['epoch_losses'])[:k]
    loss = (max(abs(g - w) / abs(w) for g, w in
                zip(got_l, r['epoch_losses'][:k]))
            if len(got_l) == k else math.inf)
    init = r['init']
    moved = {n: torch.as_tensor(out['params'][n]).to(want.device).float()
             - init[n] for n in keep}
    moved_ref = {n: r['params'][n] - init[n] for n in keep}
    return {'loss': loss, 'dtheta': leaf_gap(moved, moved_ref, keep),
            'nu': leaf_gap(out['nu'], r['nu'], keep)}


def numbers(out: dict, want: Reference, device, seed=None) -> dict:
    """One fit's numbers against the reference; `out` holds what the fit
    produced: dist, F, T (training inputs), params, emb, epoch_losses, nu,
    and optionally `span` (the columns whose span `pca` judges; the first
    columns of T otherwise). With `seed`, the training numbers too (NaN
    otherwise: not compared for this fit)."""
    dist = max(ref.rel_fro(torch.as_tensor(d), w, u)
               for d, w, u in zip(out['dist'], want.dist, want.undecided))
    f = ref.rel_fro(torch.as_tensor(out['F']), want.F)
    span = out.get('span') or out['T']
    pca = [ref.subspace_sine(b, torch.as_tensor(t).to(device)[:, :b.shape[1]])
           for b, t, gap in zip(want.basis, span, want.gaps)
           if gap <= GAP]
    emb = [torch.as_tensor(e).to(device) for e in out['emb']]
    embed = max(ref.max_rel(e, want.embed(out, i, device).float())
                for i, e in enumerate(emb))
    p = {'dist': dist, 'f': f, 'pca': max(pca) if pca else math.nan,
         'embed': embed}
    p.update(training_numbers(out, want, seed) if seed is not None
             else {k: math.nan for k in TRAINING})
    p['foscttm'] = ref.foscttm(emb[0], emb[1])
    return p


def _fails(p: dict, limits: dict) -> bool:
    """A number over its limit; a training number is judged where the fit
    has it."""
    return any(limits.get(k) is not None and not (p[k] <= limits[k])
               and not (k in TRAINING and math.isnan(p[k]))
               for k in NUMBERS)


def sampled(n_fits: int, seed: int) -> int:
    """The fit whose training is compared, drawn from the seed."""
    return random.Random(int(seed)).randrange(n_fits)


def judge(outs, want: Reference, limits: dict, device, seed: int):
    """(the worst of each number over the fits, each fit's numbers, the
    count of fits that fail a limit). The training numbers are those of
    one fit drawn from `seed`, whose training reference is drawn from the
    fits' own seed (`manual_seed`)."""
    k = sampled(len(outs), seed)
    per_fit = [numbers(o, want, device, seed=o['manual_seed'] if j == k
                       else None) for j, o in enumerate(outs)]
    worst = {n: ref.worst([p[n] for p in per_fit if not math.isnan(p[n])])
             for n in NUMBERS}
    failed = sum(1 for p in per_fit if _fails(p, limits))
    return worst, per_fit, failed


def checks_line(worst: dict, limits: dict) -> dict:
    """{number: {'value', 'limit'}} for the result line."""
    return {k: {'value': (None if math.isnan(worst[k]) else worst[k]),
                'limit': limits.get(k)} for k in NUMBERS}
