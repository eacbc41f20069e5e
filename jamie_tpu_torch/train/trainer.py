"""Training loop for the coupled VAE.

Reference parity: `jamie_tpu/train/trainer.py` (the body of the reference's
`project_jamie`, jamie/jamie.py:546-804): per-epoch minibatch sampling in
three regimes, per-batch row-normalization of the P/F subsets,
`PF_Ratio`-weighted correspondence, the 4-term loss, global-norm-1 gradient
clipping with optax's formula, Adam(model_lr, 0.9, 0.999, eps 1e-8),
per-batch or per-epoch stepping (`batch_step`), early stopping after
`min_epochs` on `max_steps_without_increment` non-improving epochs, the
last batch's loss vector in `loss_history`, and the eval-mode mu-head
embeddings in `final_embed`.

The dataset, P and F live on the device, and so does the whole epoch
(jamie_tpu's design note, :12-19): `_epoch_body` draws the epoch's batches,
runs its steps, and keeps the epoch counter and the early-stop bookkeeping
in device tensors, with no host read. On the card its start, one step and
its end are captured once per fit as CUDA graphs and replayed under a
conditional node on `not stopped` (`_CapturedEpochs`), so every epoch
after the stop is a no-op on the device, as jamie_tpu's `lax.cond` makes
it; on a mesh the same graphs hold the step's collectives, and on the CPU
the same body runs eagerly. The host dispatches `epoch_chunk` epochs at a
time, reads each chunk's losses and flags in one copy and keeps up to
`dispatch_lookahead` chunks in flight (jamie_tpu's `_fit`, :620-708), on a
mesh too; logging happens there, and a chunk dispatched after the stop is
dropped.

A fit's complete state is a `FitState` (jamie_tpu's `TrainState`,
:64-73): the flat parameters and BatchNorm stats, the Adam moments and
step count, the generator that draws the epoch sampler, dropout and noise,
and the early-stop bookkeeping. `fit(state=...)` resumes from one and equals
the uninterrupted fit; `fit(checkpoint_dir=..., checkpoint_every=...)`
snapshots it with `torch.save` and `metrics_path` writes one JSONL record per
`epoch_chunk` epochs (:573-708, 790-813).

P and F come in every form jamie_tpu's trainer takes (:110-207), and no
form but a dense one is ever built as an (N0, N1) matrix:
- P: a dense matrix, the 'identity' sentinel, a 1-D diagonal prior mask, or
  a sparse prior (SparseRows, scipy.sparse, or a coordinate tuple);
- F: a dense matrix, the 'zeros' sentinel, a sparse F (e.g. top-k), or a
  low-rank landmark F (`LowRankF`, `SparseLandmarkF`).
Each batch block P[idx0][:, idx1] / F[idx0][:, idx1] is synthesized from
the indices (`_p_sub`, `_f_sub`), and the sampling regime follows the form
(:218-259).

On a device mesh (`mesh=`, a `core.mesh` DeviceMesh; jamie_tpu's
:49-61, 97-104, 159-197, 280-299, 345-356, 759, 785):

- the data, a dense P or F, the ELL tables and the low-rank factors are
  zero-padded and row-sharded over the 'data' axis; the pad rows are never
  sampled (indices stay below the true row counts);
- every rank draws the whole batch's indices, noise and dropout masks from
  the one seeded generator and keeps its own rows of the batch, so a
  sharded fit follows the unsharded fit's random stream. A batch row may
  live on another rank: each rank fills the rows it owns into a zero
  buffer (a `where` over the whole batch, no host read) and a
  reduce-scatter hands every rank its batch rows (an all-reduce where every
  rank needs all of them, as for the column side of a low-rank F); the
  (B0, B1) blocks of P and F take the same route;
- the model is placed by `CoupledVAE.shard_` (BatchNorm over the whole
  batch, tensor parallelism on the 'model' axis by tp_wide_threshold);
  each rank's loss is its rows' share of the whole-batch means, the
  gradients are all-reduced over 'data', and the global-norm clip counts
  replicated parameters once and sums the sharded ones over 'model';
- `FitState`s, snapshots and `final_embed` / `final_corr` are in the
  unsharded layout (gathered, pad rows dropped), so a mesh fit's snapshot
  restores on one device; rank 0 alone writes snapshots and metrics and
  prints. Every rank calls every method (SPMD).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from collections import Counter, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import JamieConfig
from ..core import mesh as cm
from ..core import timing
from ..core.dtypes import resolve_device
from ..core.timing import device_memory_stats
from ..ops.lowrank import LowRankF, SparseLandmarkF, _mix_rows, \
    _scatter_rows
from ..ops.sparse import (SparseRows, as_sparse_rows, is_sparse_input,
                          sparse_gather_batch)
from .losses import (
    LOSS_NAMES, col_normalize, f_reconstruction_loss, kl_anneal,
    kl_divergence, latent_consistency_loss, reconstruction_loss,
    row_normalize,
)
from .sampling import detect_sampling_method, make_epoch_sampler


def _dense_matrix(M, name: str, rows, device) -> torch.Tensor:
    if isinstance(M, str):
        raise ValueError(f'unknown {name} sentinel {M!r}')
    if isinstance(M, torch.Tensor):
        M = M.to(device=device, dtype=torch.float32)
    else:
        M = torch.as_tensor(np.asarray(M, np.float32), device=device)
    if tuple(M.shape) != tuple(rows):
        raise ValueError(f'{name} shape {tuple(M.shape)} != dataset rows '
                         f'{tuple(rows)}')
    return M


def _ell_device(sp: SparseRows, device):
    """A SparseRows' slot tables, uploaded once."""
    return (torch.as_tensor(sp.cols.astype(np.int64), device=device),
            torch.as_tensor(sp.vals, device=device))


def adam_update(flat: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                nu: torch.Tensor, count, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> None:
    """One optax.adam(lr, b1, b2, eps) step of `flat`, in place, with its
    moments mu and nu and the step number `count` (from 1); the bias
    corrections 1 - b^t are float32, as optax computes them. `count` is an
    int, or a tensor on flat's device: then the corrections are computed
    there, with no host read (as optax computes them inside a jit), so the
    step can be captured in a CUDA graph."""
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
    if isinstance(count, torch.Tensor):
        t = count.to(torch.float32)
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
    else:
        t = np.float32(count)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
    flat.sub_(lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)))


class FlatClipAdam:
    """optax.flatten(optax.chain(clip_by_global_norm(1.0),
    adam(lr, 0.9, 0.999, eps=1e-8))) with optax's formulas, over one flat
    buffer: the chain of jamie_tpu/train/trainer.py:280-294.

    The parameters become views into one contiguous vector, and their
    `.grad`s views into one flat gradient buffer that backward accumulates
    into and `zero_grad` zeroes in place, so the clip and the Adam update
    are a few vector ops per step (jamie_tpu flattens its chain for the
    same reason) and every buffer stays where a captured CUDA graph saw it.
    The step count is a device tensor. The clip scales g -> g / ||g|| only
    when ||g|| >= 1 (torch's clip_grad_norm_ adds 1e-6 to the norm and
    always rescales); Adam's bias corrections 1 - b^t are float32 on the
    device, as optax computes them. Build it after the model is on its
    device, and never set a parameter's `.grad` to None.
    """

    MAX_NORM, B1, B2, EPS = 1.0, 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float, data_group=None, model_group=None,
                 sharded: Optional[torch.Tensor] = None):
        """On a mesh: `data_group` all-reduces the gradients; `sharded`
        (a bool mask over the flat vector) marks the parameters sharded
        over `model_group`, whose squares the clip's norm sums over it."""
        self.data_group, self.model_group = data_group, model_group
        # the replicated and the sharded entries' positions, found once: a
        # boolean index in the step would read the host
        self.split = (None if sharded is None else
                      (torch.nonzero(~sharded).squeeze(1),
                       torch.nonzero(sharded).squeeze(1)))
        self.params = list(params)
        self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        self.grad = torch.zeros_like(self.flat)
        offset = 0
        for p in self.params:
            p.data = self.flat[offset:offset + p.numel()].view_as(p)
            p.grad = self.grad[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=self.flat.device)
        self.lr = lr

    def zero_grad(self) -> None:
        self.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        """Clip the accumulated gradients, take one Adam step, zero them."""
        g = self.grad
        if self.data_group is not None:
            torch.distributed.all_reduce(g, group=self.data_group)
        if self.split is None:
            norm = torch.linalg.vector_norm(g)
        else:
            sq = g * g
            rep, tp = self.split
            norm = torch.sqrt(sq.index_select(0, rep).sum()
                              + cm.all_reduce_plain(
                                  sq.index_select(0, tp).sum(),
                                  self.model_group))
        g = torch.where(norm < self.MAX_NORM, g, g / norm * self.MAX_NORM)
        self.count.add_(1)
        adam_update(self.flat, g, self.mu, self.nu, self.count, self.lr,
                    self.B1, self.B2, self.EPS)
        self.zero_grad()


@dataclasses.dataclass
class FitState:
    """Everything a fit continues from (jamie_tpu's TrainState): the flat
    parameter vector (`FlatClipAdam.flat`'s layout), the BatchNorm running
    stats by buffer name, Adam's moments and step count, the generator's
    state, the next epoch to run and the early-stop bookkeeping."""
    params: torch.Tensor
    batch_stats: Dict[str, torch.Tensor]
    mu: torch.Tensor
    nu: torch.Tensor
    count: int
    rng: torch.Tensor
    epoch: int = 0
    best_running_loss: float = float('inf')
    streak: int = 0
    stopped: bool = False


def early_stop_update(epoch: torch.Tensor, active: torch.Tensor,
                      best: torch.Tensor, streak: torch.Tensor,
                      config: JamieConfig):
    """One epoch's early-stop bookkeeping on device tensors (jamie.py:
    777-792, jamie_tpu/train/trainer.py:506-514): past `min_epochs`, an
    epoch whose `active` loss improves on `best` by more than
    `min_increment` (float32) resets the streak, any other adds one to it;
    the fit stops once the streak reaches `max_steps_without_increment`
    (with `use_early_stop`). Returns (best, streak, stop)."""
    past_min = epoch > config.min_epochs
    improved = (best - active) > config.min_increment
    best = torch.where(past_min & improved, active, best)
    streak = torch.where(past_min, torch.where(improved, 0, streak + 1),
                         streak)
    stop = (past_min & (streak >= config.max_steps_without_increment)
            & bool(config.use_early_stop))
    return best, streak, stop


# Epochs that fits trained since the process started (or the caller cleared
# it), by route: 'captured' (CUDA graphs), 'mesh_captured' (CUDA graphs on a
# mesh, collectives inside), 'eager' (the eager body on one device) and
# 'mesh' (the eager body on a mesh). A post-stop epoch, a no-op, is not
# counted.
epoch_routes: Counter = Counter()


class _Chunk:
    """A dispatched chunk's per-epoch outputs, (epochs, 7) float32 rows of
    [epoch loss, the last batch's 4 weighted losses, stopped, ran]: on the
    card copied to pinned host memory in one transfer behind an event, read
    when the host gets to the chunk."""

    def __init__(self, rows: torch.Tensor):
        self.event = None
        if rows.is_cuda:
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            rows = host
        self.rows = rows

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.rows.numpy()


class _EagerEpochs:
    """The plain version of the captured epoch: the epoch body run op by
    op, its `not stopped` condition read on the host before each epoch. The
    route on the CPU (one device or a gloo mesh), and on the card with
    fit(eager=True)."""

    def __init__(self, trainer: 'JamieTrainer'):
        self.trainer = trainer
        self.route = 'eager' if trainer.mesh is None else 'mesh'

    def __call__(self) -> None:
        tr = self.trainer
        with torch.no_grad():
            torch.logical_not(tr._stopped, out=tr._live)
        if bool(tr._live):
            tr._epoch_body()
        tr._epoch_flags()

    def settle(self, epochs_ran: int) -> None:
        """Nothing to settle: a skipped epoch draws nothing."""

    def close(self) -> None:
        pass


class _CapturedEpochs:
    """An epoch as captured CUDA graphs: its start, one step, its end.

    The granularity is one graph per step, replayed `len_dataloader` times
    an epoch with a device step counter, plus a graph for the epoch's start
    (the sampler draw into static index buffers, the counter to 0) and one
    for its end (the accumulated step with `batch_step` off, the epoch
    loss, the early-stop bookkeeping): jamie_tpu's `lax.scan` over the
    steps of `_epoch_body`. A graph of the whole epoch would unroll its
    steps, so its size and its capture time would grow with the step count
    (the atlas trainer's 195 steps an epoch make some 160,000 nodes), where
    these three take about as long to capture as one step, whatever the
    step count. The host pays one graph launch a step, well inside the
    step's device time.

    Each part is a `core/graphs.StepGraph` with the trainer's generator
    registered, its body under an IF conditional node on `not stopped`, so
    every epoch after the early stop is a no-op on the device, as
    jamie_tpu's `lax.cond` makes it; the end's graph also writes the
    epoch's stop and ran flags. Each part's eager warm-up is put back (the
    trainer's `_device_state` and the generator), so the fit starts from
    its state. A skipped epoch still advances the generator's offset on
    the host, so `settle` puts the generator where the epochs that ran
    leave it. Nothing falls back: a failed capture or replay raises.

    On a mesh the parts hold the step's collectives (`StepGraph(mesh=
    True)`, route 'mesh_captured'), also inside the IF node's body. Every
    rank replays the same graphs and takes the same branch: `_stopped`
    comes from the all-reduced losses (`_epoch_end`).
    """

    def __init__(self, trainer: 'JamieTrainer'):
        from ..core import graphs
        tr = self.trainer = trainer
        mesh = tr.mesh is not None
        self.route = 'mesh_captured' if mesh else 'captured'
        self.start_offset = tr.generator.get_offset()
        restore = tr._device_state()
        self.parts = []
        with timing.span('trainer.capture'):
            for name, part, reps in (
                    ('epoch_start', tr._epoch_start, 1),
                    ('epoch_step', tr._epoch_step, tr.len_dataloader),
                    ('epoch_end', tr._epoch_end, 1)):
                g = graphs.StepGraph(
                    name, part, tr.device, (tr.generator,), restore=restore,
                    cond=(tr._stopped, tr._live),
                    tail=tr._epoch_flags if name == 'epoch_end' else None,
                    mesh=mesh)
                g.capture()
                self.parts.append((g, reps))
        stats = [(g.stats, reps) for g, reps in self.parts]
        self.rng_step = sum(g.increments[0] * reps for g, reps in self.parts)
        tr.graph_stats = {
            'route': self.route,
            'warmup_s': sum(st['warmup_s'] for st, _ in stats),
            'capture_s': sum(st['capture_s'] for st, _ in stats),
            'nodes': sum(reps * st['nodes'] for st, reps in stats),
            'kernel_nodes': sum(reps * st['kernel_nodes']
                                for st, reps in stats),
            'steps_per_epoch': tr.len_dataloader,
            'launches_per_epoch': sum(reps for _, reps in stats),
            'rng_offset_per_epoch': self.rng_step}

    def __call__(self) -> None:
        for g, reps in self.parts:
            g.replay(reps)

    def settle(self, epochs_ran: int) -> None:
        """The generator where `epochs_ran` epochs from the start leave it
        (call with no chunk in flight that has yet to run)."""
        self.trainer.generator.set_offset(self.start_offset
                                          + epochs_ran * self.rng_step)

    def close(self) -> None:
        self.parts = []


class JamieTrainer:
    """Owns the model, data, optimizer and generator of one fit."""

    def __init__(self, config: JamieConfig, model, dataset: Sequence,
                 P, F, device=None, mesh=None):
        if len(dataset) != 2:
            raise ValueError('Currently only compatible with 2 modalities.')
        cm.check_mesh(mesh)
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.rows = [int(d.shape[0]) for d in dataset]
        self.cols = [int(d.shape[1]) for d in dataset]
        # this rank's first global row and block size per modality
        self._blocks = [cm.row_block(n, mesh) if mesh is not None else (0, n)
                        for n in self.rows]
        # device tensors (the large PCA routes' standardized scores) are
        # taken where they lie, without a host round trip
        self.data = [self._row_block(
            d if isinstance(d, torch.Tensor) else np.asarray(d, np.float32),
            i).float() for i, d in enumerate(dataset)]
        self._init_p(P)
        self._init_f(F)
        # Row budget when final_corr must compress a low-rank F to sparse
        self._final_corr_top_k = int(config.f_top_k or 32)

        # Batch-size setup, from UnionCom via jamie.py:511-514
        self.batch_size = int(config.batch_size)
        self.len_dataloader = int(max(self.rows) / self.batch_size)
        if self.len_dataloader == 0:
            self.len_dataloader = 1
            self.batch_size = int(max(self.rows))

        self.sampling_method, corr_pairs = self._sampling_regime()
        if mesh is not None:
            self._shard_tables()
        # the batch's rows over the 'data' axis (None: all of them here)
        self._split = (cm.split_of(self.batch_size, mesh, cm.DATA)
                       if mesh is not None else None)
        self.epoch_sampler = make_epoch_sampler(
            self.sampling_method, self.rows, self.batch_size,
            self.len_dataloader, corr_pairs=corr_pairs,
            true_ratio=config.true_ratio, device=self.device)

        self.pf_ratio = 1.0 if config.PF_Ratio is None else float(config.PF_Ratio)
        if config.loss_weights is not None:
            if len(config.loss_weights) != len(LOSS_NAMES):
                raise ValueError(f'There are {len(LOSS_NAMES)} losses and '
                                 f'{len(config.loss_weights)} weights')
            weights = config.loss_weights
        else:
            weights = (1.0,) * len(LOSS_NAMES)
        self.loss_weights = torch.tensor(weights, dtype=torch.float32,
                                         device=self.device)

        # the model's parameters and stats as given, in the unsharded
        # layout: what init_state starts every fresh fit from
        self._init_params = torch.cat([p.detach().reshape(-1).clone()
                                       for p in self.model.parameters()])
        self._init_stats = {k: v.detach().clone()
                            for k, v in self._stats().items()}
        self._shapes = [(name, tuple(p.shape))
                        for name, p in self.model.named_parameters()]
        self.tp_specs = (self.model.shard_(mesh, config.tp_wide_threshold)
                         if mesh is not None else {})
        sharded = None
        if self.tp_specs:
            sharded = torch.cat([
                torch.full((p.numel(),), self.tp_specs[name] is not None,
                           device=self.device)
                for name, p in self.model.named_parameters()])
        # Grad-clip 1.0 then Adam, matching torch clip->step (jamie.py:736-742)
        self.optimizer = FlatClipAdam(
            self.model.parameters(), config.model_lr,
            data_group=cm.axis_group(mesh, cm.DATA),
            model_group=cm.axis_group(mesh, cm.MODEL), sharded=sharded)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.manual_seed)
        # jamie_tpu's TrainState scalars on the device (the next epoch and
        # the early-stop bookkeeping), an epoch's condition (not stopped)
        # and its outputs (_Chunk's row)
        dev = self.device
        self._epoch_t = torch.zeros((), dtype=torch.int64, device=dev)
        self._best = torch.full((), float('inf'), device=dev)
        self._streak = torch.zeros((), dtype=torch.int64, device=dev)
        self._stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self._live = torch.ones((), dtype=torch.bool, device=dev)
        self._out = torch.zeros(7, device=dev)
        # an epoch's static buffers: its batch indices, the step counter
        # and the batch losses
        self._idx = torch.zeros((2, self.len_dataloader, self.batch_size),
                                dtype=torch.int64, device=dev)
        self._step = torch.zeros((), dtype=torch.int64, device=dev)
        self._losses = torch.zeros(self.len_dataloader, device=dev)
        # the last fit's epoch route, with capture seconds and graph size
        # on the captured route
        self.graph_stats: Dict[str, object] = {}

    # ------------------------------------------------------------ P/F forms
    def _init_p(self, P) -> None:
        """Exactly one of: self.P (dense), _p_identity, _p_diag_mask (N,),
        _p_sparse (SparseRows, with its slot tables in _p_ell)."""
        rows = tuple(self.rows)
        self._p_identity = isinstance(P, str) and P == 'identity'
        self._p_diag_mask = None
        self._p_sparse = None
        self.P = None
        if self._p_identity:
            if rows[0] != rows[1]:
                raise ValueError("P='identity' requires equal-sized "
                                 'modalities')
        elif is_sparse_input(P):
            self._p_sparse = as_sparse_rows(P, shape=rows)
            if self._p_sparse.shape != rows:
                raise ValueError(f'sparse P shape {self._p_sparse.shape} != '
                                 f'dataset rows {rows}')
            self._p_ell = _ell_device(self._p_sparse, self.device)
        elif not isinstance(P, str) and np.ndim(P) == 1:
            if rows[0] != rows[1]:
                raise ValueError('a diagonal prior mask requires '
                                 'equal-sized modalities')
            self._p_diag_mask = np.asarray(P, np.float32)
            self._p_mask_dev = torch.as_tensor(self._p_diag_mask,
                                               device=self.device)
        else:
            self.P = _dense_matrix(P, 'P', rows, self.device)

    def _init_f(self, F) -> None:
        """Exactly one of: self.F (dense), _f_zeros, _f_lowrank (LowRankF or
        SparseLandmarkF, on this trainer's device), _f_sparse (SparseRows,
        slot tables in _f_ell)."""
        rows = tuple(self.rows)
        self._f_zeros = isinstance(F, str) and F == 'zeros'
        self._f_lowrank = None
        self._f_sparse = None
        self.F = None
        if self._f_zeros:
            return
        if isinstance(F, LowRankF):
            if F.shape != rows:
                raise ValueError(f'low-rank F shape {F.shape} != dataset '
                                 f'rows {rows}')
            # on a mesh the object stays where it is (final_corr reads it)
            # and _shard_tables puts its row blocks on the device
            self._f_lowrank = (F if self.mesh is not None
                               else F.to(self.device))
        elif is_sparse_input(F):
            self._f_sparse = as_sparse_rows(F, shape=rows)
            if self._f_sparse.shape != rows:
                raise ValueError(f'sparse F shape {self._f_sparse.shape} != '
                                 f'dataset rows {rows}')
            self._f_ell = _ell_device(self._f_sparse, self.device)
        else:
            self.F = _dense_matrix(F, 'F', rows, self.device)

    def _row_block(self, x, i: int) -> torch.Tensor:
        """x (an ndarray or tensor with modality i's rows) on the device:
        all of it without a mesh, else this rank's block of the rows
        zero-padded to the 'data' axis, in memory of its own."""
        if isinstance(x, np.ndarray):
            x = torch.as_tensor(x)
        if self.mesh is None:
            return x.to(self.device)
        start, b = self._blocks[i]
        blk = x[start:start + b].to(self.device)
        return torch.cat([blk, blk.new_zeros((b - blk.shape[0],)
                                             + tuple(blk.shape[1:]))])

    def _shard_tables(self) -> None:
        """Replace the whole P/F tables _init_p and _init_f placed with
        this rank's row blocks (the regime is already decided)."""
        if self.P is not None:
            self.P = self._row_block(self.P, 0)
        if self._p_sparse is not None:
            self._p_ell = tuple(self._row_block(t, 0) for t in self._p_ell)
        if self.F is not None:
            self.F = self._row_block(self.F, 0)
        if self._f_sparse is not None:
            self._f_ell = tuple(self._row_block(t, 0) for t in self._f_ell)
        lr = self._f_lowrank
        if isinstance(lr, SparseLandmarkF):
            self._f_tables = (self._row_block(lr.ix, 0),
                              self._row_block(lr.wx, 0),
                              self._row_block(lr.iy, 1),
                              self._row_block(lr.wy, 1),
                              lr.f_l.to(self.device))
        elif lr is not None:
            self._f_tables = (self._row_block(lr.u, 0),
                              self._row_block(lr.v, 1))

    def _local(self, idx: torch.Tensor) -> torch.Tensor:
        """This rank's entries of a batch's index vector."""
        return idx if self._split is None else self._split.local(idx)

    def _batch_rows(self, i: int, idx: torch.Tensor, take,
                    whole: bool = False) -> torch.Tensor:
        """Rows idx of modality i's row-sharded tables, where take(local
        row indices) gives the values of rows this rank holds. Without a
        mesh, take(idx). On a mesh each rank fills the rows it owns into a
        zero buffer of the batch, then a reduce-scatter over 'data' gives it
        its own batch rows, or (whole=True) an all-reduce every row.

        The buffer has static shapes and reads nothing on the host, so a
        CUDA graph can capture it: take() gets the whole batch, with the
        rows of other ranks clamped to local row 0, and a `where` (not a
        product, which would let a non-finite row through) keeps the rows
        this rank owns."""
        if self.mesh is None:
            return take(idx)
        start, b = self._blocks[i]
        own = (idx >= start) & (idx < start + b)
        vals = take(torch.where(own, idx - start, 0))
        keep = own.view((-1,) + (1,) * (vals.dim() - 1))
        buf = torch.where(keep, vals, 0)
        if whole:
            return cm.all_reduce_plain(buf, self._split.group)
        return cm.reduce_scatter_plain(buf, self._split)

    def _sampling_regime(self):
        """(method, matched pairs or None) from P's form (jamie.py:517-534,
        jamie_tpu/train/trainer.py:218-259)."""
        if self._p_identity:
            return 'diag', None
        if self._p_sparse is not None:
            sp = self._p_sparse
            if sp.nnz == 0:
                return 'zeros', None
            if (self.rows[0] == self.rows[1] and sp.nnz == self.rows[0]
                    and sp.is_diagonal() and np.allclose(sp.row_sums(), 1.0)):
                return 'diag', None
            return 'hybrid', sp.pairs()
        if self._p_diag_mask is not None:
            mask = self._p_diag_mask
            # 'diag' only for the exact identity prior, as for the dense
            # (P == eye) and sparse (diagonal, unit row sums) forms
            if (mask == 1).all():
                return 'diag', None
            if (mask > 0).any():
                nz = np.flatnonzero(mask > 0)
                return 'hybrid', np.stack([nz, nz], axis=1)
            return 'zeros', None
        P_np = self.P.cpu().numpy()
        method = detect_sampling_method(P_np)
        return method, (np.argwhere(P_np > 0) if method == 'hybrid'
                        else None)

    def _p_sub(self, idx0, idx1) -> torch.Tensor:
        """P[idx0][:, idx1] for a batch, from whichever form P has (this
        rank's rows of it on a mesh)."""
        rows0 = self._local(idx0)
        if self._p_identity:
            return (rows0[:, None] == idx1[None, :]).float()
        if self._p_sparse is not None:
            return self._batch_rows(0, idx0, lambda r: sparse_gather_batch(
                *self._p_ell, r, idx1))
        if self._p_diag_mask is not None:
            return (self._p_mask_dev[rows0][:, None]
                    * (rows0[:, None] == idx1[None, :]).float())
        return self._batch_rows(0, idx0, lambda r: self.P[r][:, idx1])

    def _f_sub(self, idx0, idx1) -> torch.Tensor:
        """F[idx0][:, idx1] for a batch, from whichever form F has (this
        rank's rows of it on a mesh)."""
        if self._f_zeros:
            return torch.zeros((self._local(idx0).shape[0], idx1.shape[0]),
                               dtype=torch.float32, device=self.device)
        if self._f_lowrank is not None:
            if self.mesh is None:
                return self._f_lowrank.gather_batch(idx0, idx1)
            if isinstance(self._f_lowrank, SparseLandmarkF):
                ix, wx, iy, wy, f_l = self._f_tables
                u_b = self._batch_rows(0, idx0, lambda r: _mix_rows(
                    ix[r], wx[r], f_l))
                v_b = self._batch_rows(1, idx1, lambda r: _scatter_rows(
                    iy[r], wy[r], f_l.shape[1]), whole=True)
            else:
                u, v = self._f_tables
                u_b = self._batch_rows(0, idx0, lambda r: u[r])
                v_b = self._batch_rows(1, idx1, lambda r: v[r], whole=True)
            return u_b @ v_b.T
        if self._f_sparse is not None:
            return self._batch_rows(0, idx0, lambda r: sparse_gather_batch(
                *self._f_ell, r, idx1))
        return self._batch_rows(0, idx0, lambda r: self.F[r][:, idx1])

    # ----------------------------------------------------------- batch step
    def batch_loss(self, idx0, idx1, epoch_idx, noise=None):
        """Weighted loss sum and its 4-vector for one batch, in train mode;
        `epoch_idx` is an int or the device epoch counter (`kl_anneal`).
        noise: optional per-modality reparameterization noise (the whole
        batch's rows). On a mesh these are this rank's rows' shares of the
        whole-batch means (`_report` sums them over 'data')."""
        cfg = self.config
        rows = self._split
        count = None if rows is None else rows.total
        x0 = self._batch_rows(0, idx0, lambda r: self.data[0][r])
        x1 = self._batch_rows(1, idx1, lambda r: self.data[1][r])
        P_sub = self._p_sub(idx0, idx1)
        F_sub = self._f_sub(idx0, idx1)
        Fn = row_normalize(F_sub)
        corr = self.pf_ratio * row_normalize(P_sub) + (1 - self.pf_ratio) * Fn
        zs, combined, x_hat, mus, logvars = self.model(
            [x0, x1], corr, generator=self.generator, noise=noise, rows=rows)
        kl = (32e-3 * kl_anneal(epoch_idx, cfg.min_epochs, cfg.epoch_DNN)
              * kl_divergence(mus, logvars, count))
        rec = reconstruction_loss(x_hat, [x0, x1], count)
        cos = latent_consistency_loss(zs, combined, cfg.dist_method, count)
        c1 = combined[1] if rows is None else cm.all_gather(combined[1], rows)
        fl = f_reconstruction_loss(combined[0], c1, Fn, count)
        vec = torch.stack([t.float() for t in (kl, rec, cos, fl)]) \
            * self.loss_weights
        return torch.sum(vec), vec

    def _report(self, loss, vec):
        """The batch's (loss, vec), detached; on a mesh the sums over
        'data' of every rank's share (the whole batch's values)."""
        if self._split is None:
            return loss.detach(), vec.detach()
        vec = cm.all_reduce_plain(vec.detach(), self._split.group)
        return torch.sum(vec), vec

    def train_step(self, idx0, idx1, epoch_idx, noise=None):
        """One batch: loss, gradients, clip, Adam. Returns (loss, vec)."""
        self.model.train()
        loss, vec = self.batch_loss(idx0, idx1, epoch_idx, noise)
        loss.backward()
        self.optimizer.step()
        return self._report(loss, vec)

    # ------------------------------------------------------------ fit state
    def _stats(self) -> Dict[str, torch.Tensor]:
        """The model's BatchNorm running stats, by buffer name (live)."""
        return dict(self.model.named_buffers())

    def init_state(self, seed: Optional[int] = None) -> FitState:
        """The state a fresh fit starts from: the parameters and stats the
        model had when this trainer was built, zero Adam moments, and the
        generator seeded with `seed` (default `config.manual_seed`). The
        model's own seed (CoupledVAE(seed=...)) draws its initialization."""
        seed = self.config.manual_seed if seed is None else seed
        return FitState(
            params=self._init_params.clone(),
            batch_stats={k: v.clone() for k, v in self._init_stats.items()},
            mu=torch.zeros_like(self._init_params),
            nu=torch.zeros_like(self._init_params),
            count=0,
            rng=torch.Generator(device=self.device).manual_seed(
                seed).get_state())

    # Tensor parallelism keeps each rank's shards live; a FitState holds
    # the unsharded layout (flat parameters in named_parameters order)
    def _tp_split(self, size: int, dim: int) -> cm.Split:
        n = cm.model_axis_size(self.mesh)
        return cm.Split(cm.axis_group(self.mesh, cm.MODEL), (size,) * n,
                        cm.axis_index(self.mesh, cm.MODEL), dim)

    def _whole(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The unsharded tensor of a live shard (gathered over 'model')."""
        dim = self.tp_specs.get(name)
        if dim is None:
            return t.detach().clone()
        return cm.gather_plain(t.detach(), self._tp_split(t.shape[dim], dim))

    def _shard(self, t: torch.Tensor, name: str) -> torch.Tensor:
        dim = self.tp_specs.get(name)
        return cm.local_shard(t, dim, cm.model_axis_size(self.mesh),
                              cm.axis_index(self.mesh, cm.MODEL))

    def _flat_whole(self, flat: torch.Tensor) -> torch.Tensor:
        """A live flat vector (parameters, moments) in the unsharded
        layout."""
        if not self.tp_specs:
            return flat.detach().clone()
        parts, off = [], 0
        for (name, _), p in zip(self._shapes, self.optimizer.params):
            t = flat[off:off + p.numel()].view_as(p)
            parts.append(self._whole(t, name).reshape(-1))
            off += p.numel()
        return torch.cat(parts)

    def _flat_shard(self, flat: torch.Tensor) -> torch.Tensor:
        if not self.tp_specs:
            return flat
        parts, off = [], 0
        for name, shape in self._shapes:
            size = int(np.prod(shape))
            t = flat[off:off + size].reshape(shape)
            parts.append(self._shard(t, name).reshape(-1))
            off += size
        return torch.cat(parts)

    def whole_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict in the unsharded layout (gathered over
        'model' under tensor parallelism; every rank calls it)."""
        return {k: self._whole(v, k)
                for k, v in self.model.state_dict().items()}

    def _capture(self, epoch: int, best, streak: int,
                 stopped: bool) -> FitState:
        """A copy of the live state in the unsharded layout: later steps
        do not change it."""
        opt = self.optimizer
        return FitState(
            params=self._flat_whole(opt.flat),
            batch_stats={k: self._whole(v, k)
                         for k, v in self._stats().items()},
            mu=self._flat_whole(opt.mu), nu=self._flat_whole(opt.nu),
            count=int(opt.count),
            rng=self.generator.get_state(), epoch=int(epoch),
            best_running_loss=float(best), streak=int(streak),
            stopped=bool(stopped))

    def _snapshot(self) -> FitState:
        """_capture with the device's epoch counter and bookkeeping."""
        return self._capture(int(self._epoch_t), float(self._best),
                             int(self._streak), bool(self._stopped))

    def _device_state(self) -> List[torch.Tensor]:
        """Every live tensor an epoch changes: the flat parameters and
        gradient, Adam's moments and count, the BatchNorm stats, the epoch
        counter and the bookkeeping."""
        opt = self.optimizer
        return [opt.flat, opt.grad, opt.mu, opt.nu, opt.count,
                *self._stats().values(), self._epoch_t, self._best,
                self._streak, self._stopped]

    @torch.no_grad()
    def _load_params(self, params, batch_stats) -> None:
        """Copy parameters and stats (unsharded layout) into the live
        buffers IN PLACE: the model's parameters are views of
        FlatClipAdam.flat, which a new tensor would silently detach."""
        live = self._stats()
        if (params.numel() != self._init_params.numel()
                or set(batch_stats) != set(live)):
            raise ValueError(f'a state of {params.numel()} parameters and '
                             f'stats {sorted(batch_stats)[:2]}... does not '
                             f'fit this model ({self._init_params.numel()} '
                             'parameters)')
        self.optimizer.flat.copy_(self._flat_shard(params))
        for k, v in batch_stats.items():
            live[k].copy_(self._shard(v, k))

    @torch.no_grad()
    def _load(self, state: FitState) -> None:
        """Make `state` the live state (in place; `state` is not changed)."""
        self._load_params(state.params, state.batch_stats)
        opt = self.optimizer
        opt.mu.copy_(self._flat_shard(state.mu))
        opt.nu.copy_(self._flat_shard(state.nu))
        opt.count.fill_(int(state.count))
        self.generator.set_state(state.rng.cpu())
        self._epoch_t.fill_(int(state.epoch))
        self._best.fill_(float(state.best_running_loss))
        self._streak.fill_(int(state.streak))
        self._stopped.fill_(bool(state.stopped))

    def save_fit_state(self, path: str, state: FitState) -> None:
        """torch.save the state at `path`, resolved to an absolute path
        (jamie_tpu/train/trainer.py:796-804); on a mesh rank 0 writes and
        the other ranks do nothing."""
        if not cm.is_rank0():
            return
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({f.name: getattr(state, f.name)
                    for f in dataclasses.fields(state)}, path)

    def restore_fit_state(self, path: str) -> FitState:
        """The state a save_fit_state file holds (tensors on the CPU; fit
        and final_embed copy them into the live buffers, and raise
        ValueError for a state of another model)."""
        return FitState(**torch.load(os.path.abspath(path),
                                     map_location='cpu', weights_only=True))

    # ------------------------------------------------------------------ fit
    def _epoch_body(self) -> None:
        """One epoch on the device with no host read (jamie_tpu's
        `_epoch_body`, trainer.py:457-530): its start, `len_dataloader`
        steps and its end. The callers run it only while not stopped
        (`_EagerEpochs`, `_CapturedEpochs`, which captures the three parts
        as graphs)."""
        self._epoch_start()
        for _ in range(self.len_dataloader):
            self._epoch_step()
        self._epoch_end()

    def _epoch_start(self) -> None:
        """The epoch's sampler draw into the static index buffers, and the
        step counter to 0."""
        idx0_all, idx1_all = self.epoch_sampler(self.generator)
        with torch.no_grad():
            self._idx[0].copy_(idx0_all)
            self._idx[1].copy_(idx1_all)
            self._step.zero_()

    def _epoch_step(self) -> None:
        """Step `_step` of the epoch, read from the device counter: its
        batch's loss and gradients, and Adam (or, with `batch_step` off, the
        gradients accumulated); the batch loss into `_losses`, its loss
        vector into `_out[1:5]` (the last batch's stays)."""
        at = self._step.view(1)
        idx0 = self._idx[0].index_select(0, at)[0]
        idx1 = self._idx[1].index_select(0, at)[0]
        if self.config.batch_step:
            loss, vec = self.train_step(idx0, idx1, self._epoch_t)
        else:   # gradients accumulate; one step per epoch (_epoch_end)
            loss, vec = self.batch_loss(idx0, idx1, self._epoch_t)
            loss.backward()
            loss, vec = self._report(loss, vec)
        with torch.no_grad():
            self._losses.index_copy_(0, at, loss.view(1))
            self._out[1:5] = vec
            self._step.add_(1)

    def _epoch_end(self) -> None:
        """The epoch's one Adam step with `batch_step` off, its loss, the
        early-stop bookkeeping from the device epoch counter, and the epoch
        loss into `_out[0]`."""
        cfg = self.config
        if not cfg.batch_step:
            self.optimizer.step()
        with torch.no_grad():
            epoch_loss = torch.sum(self._losses) / self.len_dataloader
            active = (torch.min(self._losses) if cfg.batch_step
                      else epoch_loss)
            best, streak, stop = early_stop_update(
                self._epoch_t, active, self._best, self._streak, cfg)
            self._best.copy_(best)
            self._streak.copy_(streak)
            # On a mesh the losses are the all-reduced sums (`_report`), so
            # `stop` is the same on every rank: each takes the same branch
            # of the captured IF node, whose body holds collectives that a
            # rank skipping it would leave the others waiting in
            self._stopped.copy_(stop)
            self._epoch_t.add_(1)
            self._out[0] = epoch_loss

    @torch.no_grad()
    def _epoch_flags(self) -> None:
        """The epoch's stop and ran flags into `_out[5:]`."""
        self._out[5] = self._stopped
        self._out[6] = self._live

    def _epoch_runner(self, eager: bool = False):
        """What runs one epoch from the live state: captured CUDA graphs on
        the card, on a mesh too, else (and with `eager`) the eager body."""
        self.model.train()
        self.optimizer.zero_grad()
        if eager or self.device.type != 'cuda':
            runner = _EagerEpochs(self)
            self.graph_stats = {'route': runner.route}
            return runner
        return _CapturedEpochs(self)

    def _dispatch(self, runner, chunk: int) -> _Chunk:
        """Enqueue `chunk` epochs and their outputs' copy to the host."""
        rows = torch.empty((chunk, 7), device=self.device)
        for k in range(chunk):
            runner()
            rows[k].copy_(self._out)
        return _Chunk(rows)

    def _chunk_fn(self, chunk: int):
        """A function that dispatches `chunk` epochs from the live state
        and returns their pending outputs (jamie_tpu's `_chunk_fn`; the
        bench times it). Building it captures the epoch on the card."""
        runner = self._epoch_runner()
        return lambda: self._dispatch(runner, chunk)

    def fit(self, state: Optional[FitState] = None, seed: Optional[int] = None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            metrics_path: Optional[str] = None, eager: bool = False
            ) -> FitState:
        """Run the training loop from `state` (a fresh `init_state(seed)`
        when None) up to `config.epoch_DNN` epochs; returns the final
        state, which the model also holds. `state` itself is copied in and
        stays valid.

        The host dispatches chunks of `config.epoch_chunk` epochs (counted
        from the state's epoch) and reads each chunk's per-epoch losses and
        flags in one copy, keeping up to `config.dispatch_lookahead` more
        chunks in flight (jamie_tpu's `_fit`, trainer.py:620-708). An epoch
        after the early stop is a no-op on the device, so a chunk
        dispatched after it has no epoch that ran and is dropped: the
        history, prints, metrics and snapshots are those of sequential
        dispatch. Each chunk the host reads closes with, given
        `metrics_path`, one JSONL record of jamie_tpu's keys (epoch range,
        loss means, seconds, device memory; an early stop ends the last
        range at the epochs that ran) and, given `checkpoint_dir` and
        `checkpoint_every`, a snapshot `{checkpoint_dir}/epoch_{chunk end}`
        once `checkpoint_every` epochs have passed since the last one; a
        snapshot needs the state at its chunk's end, so checkpointing
        dispatches sequentially.

        On the card the epochs run as captured CUDA graphs
        (`_CapturedEpochs`), captured once per fit, on a mesh with their
        collectives inside; a failed capture or replay raises. On the CPU
        and with `eager=True` (the plain version the captured route is held
        to) the same epoch body runs op by op. A mesh dispatches as one
        device does: every rank reads the same rows (from all-reduced
        losses), so every rank dispatches the same chunks."""
        with cm.rank0_stdout():
            return self._fit(state, seed, checkpoint_dir, checkpoint_every,
                             metrics_path, eager)

    def _fit(self, state, seed, checkpoint_dir, checkpoint_every,
             metrics_path, eager) -> FitState:
        cfg = self.config
        self.loss_history: Dict[str, List[float]] = {n: [] for n in LOSS_NAMES}
        self.epoch_losses: List[float] = []
        self.epochs_run = 0
        state = self.init_state(seed) if state is None else state
        self._load(state)
        checkpointing = bool(checkpoint_dir and checkpoint_every)
        lookahead = 0 if checkpointing else max(int(cfg.dispatch_lookahead),
                                                0)
        last_ckpt = dispatched = state.epoch
        stop_seen = bool(state.stopped)
        metrics_f = (open(metrics_path, 'a')
                     if metrics_path and cm.is_rank0() else None)
        chunk_t0 = time.perf_counter()
        runner = None
        inflight: deque = deque()
        # the epochs: the capture, the replays timed on the device, the
        # host's waits for each chunk's rows
        with timing.span('trainer.replay', device=True) as replay:
            try:
                while inflight or (dispatched < cfg.epoch_DNN
                                   and not stop_seen):
                    while (dispatched < cfg.epoch_DNN and not stop_seen
                           and len(inflight) <= lookahead):
                        if runner is None:
                            runner = self._epoch_runner(eager)
                        chunk = min(cfg.epoch_chunk,
                                    cfg.epoch_DNN - dispatched)
                        timed = timing.device_begin()
                        inflight.append((dispatched, chunk,
                                         self._dispatch(runner, chunk)))
                        if timed is not None:
                            timed.device_end()
                        dispatched += chunk
                        replay.add('epochs', chunk)
                        replay.add('steps', chunk * self.len_dataloader)
                    start, chunk, pending = inflight.popleft()
                    with timing.span('trainer.wait'):
                        rows = pending.result()
                    ran = rows[:, 6] > 0
                    if stop_seen and not ran.any():
                        continue   # dispatched before the host saw the stop
                    for k in np.flatnonzero(ran):
                        self._log_epoch(int(start + k), rows[k, 0],
                                        rows[k, 1:5])
                    epoch_routes[runner.route] += int(ran.sum())
                    end = start + chunk
                    if metrics_f is not None:
                        now = time.perf_counter()
                        some = bool(ran.any())
                        metrics_f.write(json.dumps({
                            'epoch_start': start,
                            'epoch_end': start + int(ran.sum()),
                            'epoch_loss_mean': (
                                float(np.mean(rows[ran, 0])) if some
                                else None),
                            'losses': (
                                {name: float(np.mean(rows[ran, 1 + j]))
                                 for j, name in enumerate(LOSS_NAMES)}
                                if some else {}),
                            'seconds': round(now - chunk_t0, 4),
                            'memory': device_memory_stats(self.device),
                        }) + '\n')
                        metrics_f.flush()
                        chunk_t0 = now
                    if checkpointing and end - last_ckpt >= checkpoint_every:
                        runner.settle(self.epochs_run)
                        self.save_fit_state(
                            f'{checkpoint_dir}/epoch_{end}',
                            self._snapshot())
                        last_ckpt = end
                    if rows[-1, 5] > 0:
                        stop_seen = True
                if runner is not None:
                    runner.settle(self.epochs_run)
            finally:
                if metrics_f is not None:
                    metrics_f.close()
                if runner is not None:
                    runner.close()
        self.fit_seconds = replay.seconds
        return self._snapshot()

    def _log_epoch(self, epoch: int, epoch_loss, last_vec) -> None:
        """History and prints for one epoch (jamie.py:752-775)."""
        cfg = self.config
        if cfg.record_loss:
            for j, name in enumerate(LOSS_NAMES):
                self.loss_history[name].append(float(last_vec[j]))
        self.epoch_losses.append(float(epoch_loss))
        self.epochs_run += 1
        if not np.isfinite(epoch_loss):
            warnings.warn(
                'Non-finite training loss encountered; if this persists '
                'your lr is likely too high (reference guidance, '
                'jamie/model.py:236-238).')
        if (epoch + 1) % cfg.log_debug == 0 and cfg.debug:
            print(f'Epoch: {epoch + 1:d} - ' + '  '.join(
                f'{LOSS_NAMES[j]}: {last_vec[j]:.4f}'
                for j in range(len(LOSS_NAMES))))
        if (epoch + 1) % cfg.log_DNN == 0:
            print(f'epoch:[{epoch + 1:d}/{cfg.epoch_DNN}]: '
                  f'loss:{epoch_loss:4f}')

    # ----------------------------------------------------------- inference
    def _p_sparse_form(self):
        """P as SparseRows, or None for a dense P."""
        n0, n1 = self.rows
        if self._p_sparse is not None:
            return self._p_sparse
        if self._p_diag_mask is not None:
            nz = np.flatnonzero(self._p_diag_mask)
            return SparseRows.from_coo(nz, nz, self._p_diag_mask[nz],
                                       (n0, n1))
        if self._p_identity:
            idx = np.arange(n0)
            return SparseRows.from_coo(idx, idx, np.ones(n0, np.float32),
                                       (n0, n1))
        return None

    def _f_sparse_form(self, dense_ok: bool):
        """F as SparseRows, or None for a dense F (or a low-rank F small
        enough to densify)."""
        n0, n1 = self.rows
        if self._f_sparse is not None:
            return self._f_sparse
        if self._f_zeros:
            return SparseRows.from_coo([], [], [], (n0, n1))
        if self._f_lowrank is not None and not dense_ok:
            # Column-normalize in factored form (a row scaling of V), then
            # keep each row's top correspondences
            return self._f_lowrank.col_normalized().top_k(
                self._final_corr_top_k)
        return None

    @torch.no_grad()
    def final_corr(self, max_dense_entries: int = 50_000_000):
        """Column-normalized correspondence PF_Ratio col(P) + (1 -
        PF_Ratio) col(F) (jamie.py:795-797, jamie_tpu/train/trainer.py:
        711-770). The returned embeddings never depend on it (they are the
        mu heads); kept for parity.

        Past `max_dense_entries` (N0 N1) with P and F both in sparse form it
        is returned as SparseRows (each side column-normalized, scaled, and
        the slot tables concatenated); otherwise as a dense tensor on the
        trainer's device. A low-rank F past the budget is compressed to its
        per-row top `f_top_k` (32 by default) first."""
        n0, n1 = self.rows
        dense_ok = n0 * n1 <= max_dense_entries
        Psp, Fsp = self._p_sparse_form(), self._f_sparse_form(dense_ok)
        if Psp is not None and Fsp is not None and not dense_ok:
            Pn, Fn = Psp.col_normalized(), Fsp.col_normalized()
            cols = np.concatenate([Pn.cols, Fn.cols], axis=1)
            vals = np.concatenate([self.pf_ratio * Pn.vals,
                                   (1 - self.pf_ratio) * Fn.vals], axis=1)
            return SparseRows(cols, vals, (n0, n1))
        dev = self.device
        P = (torch.as_tensor(Psp.to_dense(), device=dev) if Psp is not None
             else self._rows_whole(self.P, 0))
        if Fsp is not None:
            F = torch.as_tensor(Fsp.to_dense(), device=dev)
        elif self._f_lowrank is not None:
            F = torch.as_tensor(self._f_lowrank.to_dense(), device=dev)
        else:
            F = self._rows_whole(self.F, 0)
        return (self.pf_ratio * col_normalize(P)
                + (1 - self.pf_ratio) * col_normalize(F))

    @torch.no_grad()
    def final_embed(self, state: Optional[FitState] = None) -> List[np.ndarray]:
        """Eval-mode full-dataset mu-head embeddings per modality
        (jamie.py:794-799: the reference keeps the pre-combine latents,
        which in eval mode are the mu heads and do not depend on corr), with
        the live parameters or, given `state`, with its parameters (the
        live ones are put back afterwards)."""
        if state is not None:
            live = (self.optimizer.flat.clone(),
                    {k: v.clone() for k, v in self._stats().items()})
            self._load_params(state.params, state.batch_stats)
        try:
            self.model.eval()
            return [self._rows_whole(self.model.embed_one(x, i), i)
                    .float().cpu().numpy() for i, x in enumerate(self.data)]
        finally:
            if state is not None:
                self.optimizer.flat.copy_(live[0])
                for k, v in self._stats().items():
                    v.copy_(live[1][k])

    def _rows_whole(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Modality i's row blocks of t gathered over 'data', pad rows
        dropped (t itself without a mesh)."""
        if self.mesh is None:
            return t
        return cm.gather_plain(t, cm.block_split(t.shape[0], self.mesh))[
            :self.rows[i]]
