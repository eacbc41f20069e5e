"""The trainer's chunked epochs on the CPU: the device-side early-stop rule
against jamie_tpu's, the clip+Adam with its step count on the device
against optax, the float32 `kl_anneal` of the device epoch counter, and the
host loop's `dispatch_lookahead` and checkpointing against sequential
dispatch (the eager epoch body, the plain version of the card's captured
graphs; tests/test_torch_cuda.py holds the captured route to it)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jamie_tpu.config import JamieConfig as JConfig
from jamie_tpu.models.coupled_vae import CoupledVAE as FlaxVAE
from jamie_tpu.train import losses as jl
from jamie_tpu.train.trainer import JamieTrainer as JTrainer
from jamie_tpu_torch.config import JamieConfig
from jamie_tpu_torch.core import timing
from jamie_tpu_torch.models.coupled_vae import CoupledVAE
from jamie_tpu_torch.train import losses as tl
from jamie_tpu_torch.train import trainer as T

ROWS, DIMS = 40, (12, 9)


def _data():
    rng = np.random.RandomState(1)
    data = [rng.randn(ROWS, d).astype(np.float32) for d in DIMS]
    return data, np.eye(ROWS, dtype=np.float32), rng.rand(
        ROWS, ROWS).astype(np.float32)


# jamie_tpu's tiny fits that stop inside a chunk (epoch_chunk 16): with
# batch_step off the active loss is the epoch loss; with one batch an
# epoch (batch_size past the rows) the min batch loss is the epoch loss
# too. Both reset the streak several times before it runs out.
STOP_CASES = {
    'accumulate': dict(batch_size=16, batch_step=False,
                       max_steps_without_increment=10),
    'one_batch': dict(batch_size=64, batch_step=True,
                      max_steps_without_increment=15),
}


@pytest.mark.parametrize('case', sorted(STOP_CASES))
def test_early_stop_replays_jamie_tpu(case):
    """jamie_tpu's per-epoch losses fed one by one through the port's
    device bookkeeping (`early_stop_update`) give its epochs_run, stop
    epoch, best_running_loss and streak exactly."""
    kw = dict(dropout=0.0, output_dim=5, epoch_DNN=200, min_epochs=10,
              PF_Ratio=0.7, use_early_stop=True, min_increment=1e-3,
              epoch_chunk=16, log_DNN=10_000, **STOP_CASES[case])
    data, P, F = _data()
    jtr = JTrainer(JConfig(**kw), FlaxVAE(input_dim=DIMS, output_dim=5,
                                           dropout=0.0), data, P, F)
    ref = jtr.fit()
    assert bool(ref.stopped) and int(ref.epoch) < kw['epoch_DNN']
    assert int(ref.epoch) % kw['epoch_chunk'] != 0    # inside a chunk

    cfg = JamieConfig(**kw)
    best = torch.tensor(np.inf, dtype=torch.float32)
    streak = torch.tensor(0)
    resets, epochs_run = 0, None
    for e, loss in enumerate(jtr.epoch_losses):
        active = torch.tensor(np.float32(loss))
        before = int(streak)
        best, streak, stop = T.early_stop_update(torch.tensor(e), active,
                                                 best, streak, cfg)
        resets += int(streak) < before
        if bool(stop):
            epochs_run = e + 1
            break
    assert resets >= 2
    assert epochs_run == jtr.epochs_run == int(ref.epoch)
    assert float(best) == float(ref.best_running_loss)
    assert int(streak) == int(ref.streak)


def test_clip_adam_matches_optax():
    """FlatClipAdam (the norm, the clip and Adam's bias corrections on the
    device, the count a device tensor) over 50 steps of fixed gradients,
    some past the clip's norm of 1 and some below it, against
    optax.flatten(chain(clip_by_global_norm(1), adam(1e-3))). Both are
    float32 with optax's formulas; the libraries' pow, sqrt and norm round
    differently, held at 2e-7 absolute on parameters of order 1 (measured
    worst: 3.0e-8)."""
    rng = np.random.RandomState(4)
    init = [rng.randn(7, 5).astype(np.float32),
            rng.randn(5).astype(np.float32)]
    grads = [[(rng.randn(*p.shape) * (0.05 if k % 3 else 2.0))
              .astype(np.float32) for p in init] for k in range(50)]

    params = [torch.nn.Parameter(torch.tensor(p)) for p in init]
    opt = T.FlatClipAdam(params, 1e-3)
    for g in grads:
        for p, gk in zip(params, g):
            p.grad.copy_(torch.tensor(gk))
        opt.step()
        assert all(not p.grad.any() for p in params)     # zeroed in place
    assert isinstance(opt.count, torch.Tensor) and int(opt.count) == 50

    tx = optax.flatten(optax.chain(optax.clip_by_global_norm(1.0),
                                   optax.adam(1e-3, b1=0.9, b2=0.999,
                                              eps=1e-8)))
    ref = [jnp.asarray(p) for p in init]
    state = tx.init(ref)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, ref)
        ref = optax.apply_updates(ref, updates)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=0, atol=2e-7)


@pytest.mark.parametrize('min_epochs, epoch_dnn', [(100, 400), (0, 400)])
def test_kl_anneal_of_the_device_epoch(min_epochs, epoch_dnn):
    """kl_anneal of a device epoch counter is float32, against jamie_tpu's
    of a traced int32 epoch (its jitted chunk): float32 exp in two
    libraries, held at rtol 1e-6 (measured: within one float32 ulp, 4.9e-7
    relative at epoch 0)."""
    ref = jax.jit(lambda e: jl.kl_anneal(e, min_epochs, epoch_dnn))
    for epoch in (0, 3, 50, 99, 400):
        ours = tl.kl_anneal(torch.tensor(epoch), min_epochs, epoch_dnn)
        want = ref(jnp.int32(epoch))
        assert ours.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(want),
                                   rtol=1e-6)


def _trainer(**overrides):
    data, P, F = _data()
    kw = dict(dropout=0.3, batch_size=16, output_dim=5, epoch_DNN=40,
              min_epochs=5, PF_Ratio=0.7, epoch_chunk=5, log_DNN=2,
              debug=True, log_debug=3, use_early_stop=True,
              max_steps_without_increment=2, min_increment=1e9)
    kw.update(overrides)
    cfg = JamieConfig(**kw)
    return T.JamieTrainer(cfg, CoupledVAE(DIMS, 5, dropout=cfg.dropout,
                                          seed=3), data, P, F, device='cpu')


def _assert_states_equal(a, b):
    for name in ('params', 'mu', 'nu', 'rng'):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for k in a.batch_stats:
        assert torch.equal(a.batch_stats[k], b.batch_stats[k]), k
    for name in ('count', 'epoch', 'best_running_loss', 'streak', 'stopped'):
        assert getattr(a, name) == getattr(b, name), name


def _records(path):
    return [{k: v for k, v in json.loads(line).items()
             if k not in ('seconds', 'memory')} for line in open(path)]


@pytest.mark.parametrize('batch_step', [True, False])
def test_lookahead_equals_sequential_dispatch(tmp_path, capsys, batch_step):
    """dispatch_lookahead 0 and 3 on a fit whose stop lands inside a chunk
    (min_epochs 5, streak 2: the stop at 0-based epoch 8, in the chunk of
    epochs 5-9; dropout on, so the generator carries the draws): the same
    history, prints and metrics records (seconds and memory left out), and
    a bit-equal final FitState. Lookahead 3 dispatched chunks past the stop
    that ran nothing and were dropped."""
    out = []
    for lookahead in (0, 3):
        tr = _trainer(batch_step=batch_step, dispatch_lookahead=lookahead)
        dispatched = []
        real = tr._dispatch
        tr._dispatch = lambda r, c: dispatched.append(c) or real(r, c)
        path = tmp_path / f'metrics_{lookahead}.jsonl'
        state = tr.fit(metrics_path=str(path))
        out.append(dict(state=state, history=tr.loss_history,
                        losses=tr.epoch_losses, run=tr.epochs_run,
                        records=_records(path), printed=capsys.readouterr().out,
                        dispatched=len(dispatched)))
    seq, ahead = out
    assert seq['run'] == ahead['run'] == 9
    assert seq['state'].stopped and seq['state'].epoch == 9
    assert seq['history'] == ahead['history']
    assert seq['losses'] == ahead['losses']
    assert seq['printed'] == ahead['printed'] and 'Epoch: 3 -' in seq['printed']
    assert seq['records'] == ahead['records']
    assert [(r['epoch_start'], r['epoch_end']) for r in seq['records']] == [
        (0, 5), (5, 9)]
    _assert_states_equal(seq['state'], ahead['state'])
    assert (seq['dispatched'], ahead['dispatched']) == (2, 5)


def test_checkpointing_dispatches_sequentially(tmp_path):
    """With checkpoint_every the host reads each chunk before it
    dispatches the next, whatever dispatch_lookahead says, and the
    snapshots (one at the stop's chunk) equal the sequential fit's."""
    events = []
    states = []
    for lookahead in (0, 3):
        tr = _trainer(dispatch_lookahead=lookahead)
        real_dispatch, real_result = tr._dispatch, T._Chunk.result
        tr._dispatch = lambda r, c: events.append('d') or real_dispatch(r, c)
        ck = tmp_path / str(lookahead)
        try:
            T._Chunk.result = lambda self: (events.append('r'),
                                            real_result(self))[1]
            tr.fit(checkpoint_dir=str(ck), checkpoint_every=5)
        finally:
            T._Chunk.result = real_result
        assert ''.join(events) == 'dr' * 2
        events.clear()
        states.append([tr.restore_fit_state(str(ck / f'epoch_{e}'))
                       for e in (5, 10)])
    for a, b in zip(*states):
        _assert_states_equal(a, b)
    assert states[1][1].stopped and states[1][1].epoch == 9


def test_stopped_epochs_are_no_ops():
    """An epoch run after the stop changes nothing (parameters, stats,
    Adam moments and count, the bookkeeping, the generator) and reports
    ran = 0; a fit from a stopped state runs no epoch."""
    tr = _trainer()
    state = tr.fit()
    assert state.stopped
    before = [t.clone() for t in tr._device_state()]
    rng = tr.generator.get_state()
    runner = tr._epoch_runner()
    rows = tr._dispatch(runner, 3).result()
    assert (rows[:, 6] == 0).all() and (rows[:, 5] == 1).all()
    for a, b in zip(tr._device_state(), before):
        assert torch.equal(a, b)
    assert torch.equal(tr.generator.get_state(), rng)
    again = tr.fit(state=state)
    assert tr.epochs_run == 0
    _assert_states_equal(again, state)


def test_chunk_fn_runs_epochs_from_the_live_state():
    """The bench's chunk function dispatches `chunk` epochs from the live
    state: two calls of 3 equal one fit of 6 (no early stop)."""
    a = _trainer(use_early_stop=False, epoch_DNN=6)
    whole = a.fit()
    b = _trainer(use_early_stop=False, epoch_DNN=6)
    b._load(b.init_state())
    with timing.span('chunks') as sp:
        fn = b._chunk_fn(3)
        rows = np.concatenate([fn().result(), fn().result()])
    # the eager body, with the block tails' composed ops
    assert sp.counters == {'blocks_fused': 0} and not sp.children
    np.testing.assert_array_equal(rows[:, 0], np.float32(a.epoch_losses))
    _assert_states_equal(b._snapshot(), whole)


def test_replay_span_counts_the_epochs_that_ran():
    """The `trainer.replay` span counts the epochs a fit trained, as the
    loop 'epochs' on its route: under lookahead 3 the no-op epochs of the
    chunks dispatched past the stop add nothing."""
    tr = _trainer(dispatch_lookahead=3)
    with timing.span('fit') as sp:
        tr.fit()
    assert tr.epochs_run == 9
    (replay,) = sp.find('trainer.replay')
    assert replay.counters['loops'] == {'epochs/eager': 9}
    assert timing.routes(sp) == {'epochs/eager': 9}


@pytest.mark.parametrize('batch_step', [True, False])
def test_fit_steps_through_train_step(batch_step):
    """With batch_step on, every batch of the fit's epochs is one
    `train_step` (the step tests/test_torch_train.py holds against
    jamie_tpu); with it off the batches accumulate and no train_step
    runs."""
    tr = _trainer(batch_step=batch_step, use_early_stop=False, epoch_DNN=4)
    calls = []
    real = tr.train_step
    tr.train_step = lambda *a, **k: calls.append(1) or real(*a, **k)
    tr.fit()
    assert len(calls) == (4 * tr.len_dataloader if batch_step else 0)
