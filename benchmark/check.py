"""Whether the fits of a run are correct: what each fit produced against
the plain reference (`reference.py`), number by number, each against its
limit in `workloads/<cell>.json` (a limit of null: not compared there; a
number that is missing, NaN, fails a limit that is not null).

The numbers, each the worst over the run's fits:

- `dist`, `f`, `pca`: the stages a route makes its own way, judged by the
  `Reference` of the configuration's harness module (`harness/<name>.py`;
  `harness/dense.py` says how it judges them); NaN where it does not;
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

The training reference takes the fit's PCA projections and F (as the
harness's `Reference.training_f` gives it) as its inputs: those stages
are judged by themselves (`pca`, `f`).
"""

from __future__ import annotations

import math
import random
import statistics

import torch

import reference as ref

NUMBERS = ('dist', 'f', 'pca', 'embed', 'loss', 'dtheta', 'nu', 'foscttm')
# The numbers a harness's `Reference.numbers` gives
ROUTE = ('dist', 'f', 'pca')
TRAINING = ('loss', 'dtheta', 'nu')
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


class ModelReference:
    """The reference of the stages every route shares: the coupled VAE's
    training on a fit's inputs and its mean head, in the precision the
    configuration states for 'model', or with `control`, one below. A
    harness's `Reference` builds on it with the stages of its route and
    `numbers` (`dist`, `f`, `pca`)."""

    def __init__(self, config: dict, traffic: dict, device,
                 control: bool = False):
        ref.plain_matmuls()
        table = LOWER if control else STATED
        self.rnd = {stage: table[p]
                    for stage, p in config['precision'].items()}
        self.config = config
        self.kwargs = dict(config['kwargs'], **traffic['kwargs'])
        self.device = torch.device(device)
        self._trained = None

    def numbers(self, out: dict, device) -> dict:
        """`dist`, `f`, `pca` of one fit's `out`; NaN where not judged."""
        raise NotImplementedError

    def training_f(self, out: dict):
        """The dense F that the training reference takes: the fit's."""
        return out['F']

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


def training_numbers(out: dict, want: ModelReference, seed: int) -> dict:
    """`loss`, `dtheta`, `nu` of one fit against the reference's training
    on the same inputs."""
    r = want.train(out['T'], want.training_f(out), seed)
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


def numbers(out: dict, want: ModelReference, device, seed=None) -> dict:
    """One fit's numbers against the reference; `out` holds what the fit
    produced: T (training inputs), params, emb, epoch_losses, nu, and what
    its harness's `produced` names (dense: dist, F). With `seed`, the
    training numbers too (NaN otherwise: not compared for this fit)."""
    route = want.numbers(out, device)
    emb = [torch.as_tensor(e).to(device) for e in out['emb']]
    embed = max(ref.max_rel(e, want.embed(out, i, device).float())
                for i, e in enumerate(emb))
    p = {k: route[k] for k in ROUTE}
    p['embed'] = embed
    p.update(training_numbers(out, want, seed) if seed is not None
             else {k: math.nan for k in TRAINING})
    p['foscttm'] = ref.foscttm(emb[0], emb[1])
    return p


def _fails(p: dict, limits: dict, trained: bool = True) -> bool:
    """A number over its limit, or missing (NaN) where its limit is not
    null; the training numbers are judged only in the fit whose training
    is compared (`trained`)."""
    return any(limits.get(k) is not None and not (p[k] <= limits[k])
               and not (k in TRAINING and not trained)
               for k in NUMBERS)


def sampled(n_fits: int, seed: int) -> int:
    """The fit whose training is compared, drawn from the seed."""
    return random.Random(int(seed)).randrange(n_fits)


def judge(outs, want: ModelReference, limits: dict, device, seed: int):
    """(the worst of each number over the fits, each fit's numbers, the
    count of fits that fail a limit). The training numbers are those of
    one fit drawn from `seed`, whose training reference is drawn from the
    fits' own seed (`manual_seed`)."""
    k = sampled(len(outs), seed)
    per_fit = [numbers(o, want, device, seed=o['manual_seed'] if j == k
                       else None) for j, o in enumerate(outs)]
    worst = {n: ref.worst([p[n] for p in per_fit if not math.isnan(p[n])])
             for n in NUMBERS}
    failed = sum(1 for j, p in enumerate(per_fit)
                 if _fails(p, limits, trained=j == k))
    return worst, per_fit, failed


def checks_line(worst: dict, limits: dict) -> dict:
    """{number: {'value', 'limit'}} for the result line."""
    return {k: {'value': (None if math.isnan(worst[k]) else worst[k]),
                'limit': limits.get(k)} for k in NUMBERS}
