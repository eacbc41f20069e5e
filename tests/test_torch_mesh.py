"""jamie_tpu_torch's device mesh on the CPU: gloo ranks in spawned processes
(core.mesh.spawn_local) against jamie_tpu's mesh on the 8-device virtual
CPU mesh of tests/conftest.py, and against the port's unsharded path where
the two random streams cannot match.

The workers are the module-level functions below. A spawned process
imports this module by name, so the module imports neither jax nor
jamie_tpu at its top (the test bodies and fixtures do), and every worker
checks that neither was imported. Each spawn runs several checks and
returns their results; the tests hold them to the references."""

import contextlib
import functools
import glob
import importlib
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from jamie_tpu_torch import JAMIE
from jamie_tpu_torch.config import JamieConfig
from jamie_tpu_torch.core import graphs
from jamie_tpu_torch.core import mesh as cm
from jamie_tpu_torch.models.convert import (load_flax_variables,
                                            to_flax_variables)
from jamie_tpu_torch.models.coupled_vae import CoupledVAE
from jamie_tpu_torch.ops.distances import pairwise_distance
from jamie_tpu_torch.ops.lowrank import LowRankF, SparseLandmarkF
from jamie_tpu_torch.ops.sparse import SparseRows
from jamie_tpu_torch.train.trainer import JamieTrainer

# the submodule: jamie_tpu_torch.solvers binds the function prime_dual
pd = importlib.import_module('jamie_tpu_torch.solvers.prime_dual')

METRICS = ('euclidean', 'sqeuclidean', 'cosine', 'correlation')
BLOCKED = ('jax', 'jaxlib', 'flax', 'jamie_tpu')


def _no_jax():
    leaked = cm.modules_loaded(*BLOCKED)
    assert not leaked, f'a mesh worker imported {leaked}'


# ------------------------------------------------------------ the inputs
def _distance_input():
    return np.random.RandomState(2).randn(41, 7).astype(np.float32)


def _solver_inputs():
    """(name, Kx, Ky, dx, dy): 32 x 32 and the odd 37 x 29."""
    rng = np.random.RandomState(6)
    sq = lambda a: np.sqrt(((a[:, None] - a[None]) ** 2).sum(-1)).astype(
        np.float32)
    x = rng.randn(32, 6).astype(np.float32)
    a = rng.randn(37, 5).astype(np.float32)
    b = rng.randn(29, 4).astype(np.float32)
    return [('32x32', sq(x), sq(x), 6, 6), ('37x29', sq(a), sq(b), 5, 4)]


def _step_setup():
    """test_torch_train._setup's one-step inputs: 40 rows, dims (12, 9),
    batch 16, PF_Ratio 0.7 over P = I and a dense random F."""
    rng = np.random.RandomState(1)
    data = [rng.randn(40, d).astype(np.float32) for d in (12, 9)]
    P = np.eye(40, dtype=np.float32)
    F = rng.rand(40, 40).astype(np.float32)
    cfg_kw = dict(dropout=0.0, batch_size=16, output_dim=5, epoch_DNN=50,
                  min_epochs=10, PF_Ratio=0.7)
    idx0 = np.array([3, 17, 8, 0, 25, 39, 11, 30, 5, 21, 14, 2, 33, 7, 19,
                     28])
    return data, P, F, cfg_kw, idx0, np.roll(idx0, 3)


def _fit_data(n, f0, f1, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 4).astype(np.float32)
    return [(z @ rng.randn(4, f0)).astype(np.float32),
            (z @ rng.randn(4, f1)).astype(np.float32)]


FIT_CASES = {  # name: (n, f0, f1, seed, epochs, batch, tp_wide_threshold)
    'even': (64, 16, 12, 0, 30, 32, 1024),
    'odd': (67, 14, 10, 7, 20, 32, 1024),
    'tp256': (64, 256, 32, 3, 20, 32, 256),
    'tp1024': (32, 1024, 24, 8, 6, 16, 1024),
}


def _trainer(case, mesh):
    n, f0, f1, seed, epochs, batch, wt = FIT_CASES[case]
    cfg = JamieConfig(epoch_DNN=epochs, min_epochs=1, batch_size=batch,
                      epoch_chunk=10, use_early_stop=False, pca_dim=None,
                      log_DNN=1000, tp_wide_threshold=wt)
    model = CoupledVAE((f0, f1), cfg.output_dim, dropout=0.0)
    return JamieTrainer(cfg, model, _fit_data(n, f0, f1, seed),
                        np.eye(n, dtype=np.float32),
                        np.zeros((n, n), np.float32), device='cpu',
                        mesh=mesh)


def _fit(case, mesh):
    tr = _trainer(case, mesh)
    state = tr.fit()
    return dict(losses=np.asarray(tr.epoch_losses),
                embed=tr.final_embed(state),
                rows=[int(d.shape[0]) for d in tr.data],
                corr_shape=tuple(tr.final_corr().shape))


def _step(mesh, ref, tp_wide_threshold):
    """One train_step on the mesh from jamie_tpu's parameters, indices and
    noise; returns (vec, flax params, flax batch stats, specs) unsharded."""
    data, P, F, cfg_kw, idx0, idx1 = _step_setup()
    model = CoupledVAE((12, 9), 5, dropout=0.0)
    load_flax_variables(model, ref['params'], ref['bstats'])
    tr = JamieTrainer(JamieConfig(tp_wide_threshold=tp_wide_threshold,
                                  **cfg_kw), model, data, P, F,
                      device='cpu', mesh=mesh)
    _, vec = tr.train_step(torch.as_tensor(idx0), torch.as_tensor(idx1),
                           ref['epoch'],
                           noise=[torch.as_tensor(z) for z in ref['noise']])
    state = tr._capture(0, np.inf, 0, False)
    whole = CoupledVAE((12, 9), 5, dropout=0.0)
    torch.nn.utils.vector_to_parameters(state.params, whole.parameters())
    whole.load_state_dict(state.batch_stats, strict=False)
    params, stats = to_flax_variables(whole)
    return vec.numpy(), params, stats, {k: v for k, v in tr.tp_specs.items()
                                        if v is not None}


# ------------------------------------------- capturable mesh steps
class _NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a tensor on the host or sizes its output
    from the data (a boolean index is a nonzero): the CPU's stand-in for
    "a CUDA graph can capture this step"."""

    READS = {'nonzero', '_local_scalar_dense', 'is_nonzero', 'masked_select'}
    INDEXED = {'index', 'index_put', 'index_put_', '_index_put_impl_'}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if name in self.READS or (name in self.INDEXED and any(
                t is not None and t.dtype == torch.bool for t in args[1])):
            raise RuntimeError(f'host read in a mesh step: {func}')
        return func(*args, **(kwargs or {}))


def _batch_rows_masked(tr, i, idx, take, whole=False):
    """The batch-row exchange by boolean-mask indexing (the trainer's
    before its mesh loop was captured): the reference of its buffer."""
    start, b = tr._blocks[i]
    own = (idx >= start) & (idx < start + b)
    vals = take(idx[own] - start)
    buf = vals.new_zeros((idx.shape[0],) + tuple(vals.shape[1:]))
    buf[own] = vals
    if whole:
        return cm.all_reduce_plain(buf, tr._split.group)
    return cm.reduce_scatter_plain(buf, tr._split)


def _form_trainers(mesh, inf_row=False):
    """A trainer on the mesh for each P and F form, 40 rows a modality
    (10 a rank on 4 ranks), batch 16; with `inf_row`, modality 0's row 10
    is infinite: rank 1's local row 0, where the other ranks' rows are
    clamped."""
    n, k = 40, 3
    rng = np.random.RandomState(11)
    data = [rng.randn(n, d).astype(np.float32) for d in (12, 9)]
    if inf_row:
        data[0][10] = np.inf
    dense = rng.rand(n, n).astype(np.float32)
    P = dense * (dense > 0.7)
    rows, cols = np.nonzero(P)
    half = (np.arange(n) % 2).astype(np.float32)
    lm = [np.stack([rng.choice(8, k, replace=False) for _ in range(n)])
          for _ in range(2)]
    forms = {
        'dense_dense': (P, dense),
        'sparse_sparse': (SparseRows.from_coo(rows, cols, P[rows, cols],
                                              (n, n)),
                          SparseRows.top_k(dense, 4)),
        'identity_lowrank': ('identity', LowRankF(
            rng.rand(n, 5), rng.rand(n, 5), device='cpu')),
        'mask_landmark': (half, SparseLandmarkF(
            lm[0], rng.rand(n, k), lm[1], rng.rand(n, k), rng.rand(8, 8),
            device='cpu')),
        'dense_zeros': (P, 'zeros'),
    }
    cfg = JamieConfig(batch_size=16, output_dim=5, dropout=0.0)
    return {name: JamieTrainer(cfg, CoupledVAE((12, 9), 5, dropout=0.0),
                               data, Pf, Ff, device='cpu', mesh=mesh)
            for name, (Pf, Ff) in forms.items()}


def _batch_blocks(tr, idx0, idx1):
    """Every block `batch_loss` exchanges: x0, x1, P_sub, F_sub."""
    return (tr._batch_rows(0, idx0, lambda r: tr.data[0][r]),
            tr._batch_rows(1, idx1, lambda r: tr.data[1][r]),
            tr._p_sub(idx0, idx1), tr._f_sub(idx0, idx1))


def _batch_rows_checks(mesh):
    """Per form and batch: whether the static exchange equals the masked
    one bit for bit, whether x0 is finite and whether the batch holds the
    infinite row, and whether the guard catches the masked exchange."""
    rng = np.random.RandomState(12)
    batches = {  # 'rank0_only': ranks 1-3 own no row of either side
        'spread': (rng.randint(0, 40, 16), rng.randint(0, 40, 16)),
        'rank0_only': (rng.randint(0, 10, 16), rng.randint(0, 10, 16)),
        'rank3_only': (rng.randint(11, 40, 16), rng.randint(30, 40, 16)),
    }
    out = {}
    for name, tr in _form_trainers(mesh, inf_row=True).items():
        for tag, (i0, i1) in batches.items():
            idx0, idx1 = torch.as_tensor(i0), torch.as_tensor(i1)
            got = _batch_blocks(tr, idx0, idx1)
            tr._batch_rows = functools.partial(_batch_rows_masked, tr)
            want = _batch_blocks(tr, idx0, idx1)
            try:
                with _NoHostRead():
                    _batch_blocks(tr, idx0, idx1)
                caught = False
            except RuntimeError:
                caught = True
            del tr._batch_rows
            out[(name, tag)] = dict(
                equal=all(torch.equal(a, b) for a, b in zip(got, want)),
                finite=bool(torch.isfinite(got[0]).all()),
                inf_row=bool((idx0 == 10).any()), caught=caught)
    return out


def _guarded_epoch(tr):
    """One epoch's three parts under _NoHostRead; the epoch's losses."""
    tr._load(tr.init_state())
    tr.model.train()
    tr.optimizer.zero_grad()
    with _NoHostRead():
        tr._epoch_start()
        for _ in range(tr.len_dataloader):
            tr._epoch_step()
        tr._epoch_end()
        tr._epoch_flags()
    return tr._out.clone()


def _guarded_prime_dual(mesh, Kx, Ky, dx, dy, **kw):
    """prime_dual on the mesh with every iteration under _NoHostRead (the
    host reads of the log lines stay outside), and the same solve
    unguarded."""
    def runner(name, step, device, generators=(), mesh=False):
        def guarded():
            with _NoHostRead():
                step()
        return graphs.EagerSteps(name, guarded, 'mesh')
    plain = pd.prime_dual(Kx, Ky, dx, dy, device='cpu', mesh=mesh, **kw)
    real = pd.graphs.steps_runner
    pd.graphs.steps_runner = runner
    try:
        guarded = pd.prime_dual(Kx, Ky, dx, dy, device='cpu', mesh=mesh,
                                **kw)
    finally:
        pd.graphs.steps_runner = real
    return guarded, plain


STOP_KW = dict(epoch_DNN=40, min_epochs=5, batch_size=16, epoch_chunk=5,
               log_DNN=1, use_early_stop=True, max_steps_without_increment=2,
               min_increment=1e9, dropout=0.3)


def _lookahead_fits(mesh):
    """The same mesh fit with dispatch_lookahead 0 and 2, its early stop
    inside a chunk: each one's epochs, history, prints, metrics records and
    final state."""
    data, P, F = _step_setup()[:3]
    out = {}
    for la in (0, 2):
        cfg = JamieConfig(dispatch_lookahead=la, output_dim=5, **STOP_KW)
        tr = JamieTrainer(cfg, CoupledVAE((12, 9), 5, dropout=0.3), data, P,
                          F, device='cpu', mesh=mesh)
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'metrics.jsonl')
            with contextlib.redirect_stdout(buf):
                state = tr.fit(metrics_path=path)
            records = ([{k: v for k, v in json.loads(ln).items()
                         if k != 'seconds'} for ln in open(path)]
                       if cm.is_rank0() else [])
        out[la] = dict(run=tr.epochs_run, history=tr.loss_history,
                       losses=tr.epoch_losses, prints=buf.getvalue(),
                       records=records, state=state)
    return out


# --------------------------------------------------------------- workers
def _worker_data_mesh(mesh, step_ref, snap_dir, pair):
    """The checks on a 4-rank ('data',) mesh."""
    _no_jax()
    out = {'rank': cm.rank()}
    x = _distance_input()
    out['distances'] = {m: pairwise_distance(x, m, device='cpu',
                                             mesh=mesh).numpy()
                        for m in METRICS}
    out['prime_dual'] = {
        (name, prec): pd.prime_dual(Kx, Ky, dx, dy, epoch_pd=100,
                                    verbose=False, precision=prec,
                                    device='cpu', mesh=mesh).numpy()
        for name, Kx, Ky, dx, dy in _solver_inputs()
        for prec in ('highest', 'default')}
    # per-rank solver state at m = n = 1024: 1/world of each (m, n) array
    K = np.zeros((1024, 1024), np.float32)
    Kx, _, _, state, rows = pd.init_state(K, K, 1, 1, 'float32', True,
                                          torch.device('cpu'), mesh)
    out['state'] = {k: tuple(v.shape) for k, v in state.items()}
    out['state']['Kx'] = tuple(Kx.shape)
    out['state_rows'] = rows
    with pytest.raises(ValueError, match='needs 8 devices, have 4'):
        cm.create_mesh((8,))
    with pytest.raises(ValueError, match='covers 2 of 4'):
        cm.create_mesh((2,))
    out['step'] = _step(mesh, step_ref, 1024)
    out['fits'] = {case: _fit(case, mesh) for case in ('even', 'odd')}
    # the auto mesh: JAMIE() on a 4-rank group shards by itself
    data, kw = pair
    jm = JAMIE(device='cpu', checkpoint_dir=snap_dir, checkpoint_every=20,
               **kw)
    out['auto_mesh'] = dict(zip(jm.mesh.mesh_dim_names, jm.mesh.mesh.shape))
    emb = jm.fit_transform(dataset=data)
    out['auto_fit'] = dict(embed=emb, foscttm=jm.test_closer(emb))
    plain = JAMIE(device='cpu', use_mesh=False, **kw)
    out['plain_mesh'] = plain.mesh
    emb_pl = plain.fit_transform(dataset=data)
    out['plain_fit'] = dict(embed=emb_pl, foscttm=plain.test_closer(emb_pl))
    # the mesh loops' steps as a CUDA graph needs them: no host read
    out['batch_rows'] = _batch_rows_checks(mesh)
    trainers = _form_trainers(mesh)
    out['guarded_epochs'] = {
        name: _guarded_epoch(trainers[name])
        for name in ('dense_dense', 'mask_landmark')}
    _, Kx, Ky, dx, dy = _solver_inputs()[1]
    out['guarded_pd'] = _guarded_prime_dual(mesh, Kx, Ky, dx, dy,
                                            epoch_pd=12, delay=3, log_pd=5)
    out['lookahead'] = _lookahead_fits(mesh)
    _no_jax()
    return out


def _worker_2d_mesh(mesh, step_ref, model_path):
    """The checks on a (2, 2) ('data', 'model') mesh."""
    _no_jax()
    out = {'mesh': dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}
    out['step'] = _step(mesh, step_ref, 8)
    for case in ('tp256', 'tp1024'):
        tr = _trainer(case, mesh)
        layers = tr.model.layers
        n, f0 = FIT_CASES[case][:2]
        out[case + '_split'] = dict(
            kernel=tuple(layers['enc0_b0'].dense.weight.shape),
            bn=tuple(layers['enc0_b0'].bn.running_mean.shape),
            mu=int(tr.optimizer.mu.numel()),
            whole=int(tr._init_params.numel()))
        state = tr.fit()
        out[case] = dict(losses=np.asarray(tr.epoch_losses),
                         embed=tr.final_embed(state))
    # JAMIE through mesh_shape alone (4 ranks: the auto mesh)
    rng = np.random.RandomState(4)
    z = rng.randn(64, 4).astype(np.float32)
    data = [(z @ rng.randn(4, 48)).astype(np.float32),
            (z @ rng.randn(4, 16)).astype(np.float32)]
    jm = JAMIE(device='cpu', mesh_shape=(2, 2),
               mesh_axis_names=('data', 'model'), tp_wide_threshold=32,
               epoch_DNN=10, min_epochs=5, batch_size=32, epoch_chunk=10,
               pca_dim=None, epoch_pd=50, use_early_stop=False, log_DNN=1000,
               log_pd=1000)
    emb = jm.fit_transform(dataset=data)
    out['estimator'] = dict(
        mesh=dict(zip(jm.mesh.mesh_dim_names, jm.mesh.mesh.shape)),
        shape=emb[0].shape, finite=bool(np.isfinite(emb[0]).all()),
        kernel=tuple(jm.model.layers['enc0_b0'].dense.weight.shape),
        predict=jm.modal_predict(data[0], 0), data=data)
    jm.save_model(model_path)     # every rank calls, rank 0 writes
    # tensor parallelism's step (the clip's norm over 'model') reads
    # nothing on the host either
    out['guarded_epoch'] = _guarded_epoch(_trainer('tp256', mesh))
    _no_jax()
    return out


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope='module')
def step_ref():
    """jamie_tpu's one step (test_torch_train's) with its inputs: the
    initial parameters, the noise it drew, the loss vector, the updated
    parameters, gradients and batch stats."""
    import jax
    import jax.numpy as jnp
    import optax
    from jamie_tpu.config import JamieConfig as JConfig
    from jamie_tpu.models.coupled_vae import CoupledVAE as FlaxVAE
    from jamie_tpu.train.trainer import JamieTrainer as JTrainer

    data, P, F, cfg_kw, idx0, idx1 = _step_setup()
    jtr = JTrainer(JConfig(**cfg_kw), FlaxVAE(input_dim=(12, 9), output_dim=5,
                                               dropout=0.0), data, P, F)
    state = jtr.init_state()
    epoch, key = 12, jax.random.PRNGKey(9)
    _, vec, new_bs, grads = jtr._batch_loss_and_grads(
        state.params, state.batch_stats, key, epoch, jtr._operands(),
        jnp.asarray(idx0), jnp.asarray(idx1))
    updates, _ = jtr.tx.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    k_d, k_r = jax.random.split(key)
    (zs, _, _, mus, logvars), _ = jtr.model.apply(
        {'params': state.params, 'batch_stats': state.batch_stats},
        [jnp.asarray(data[0][idx0]), jnp.asarray(data[1][idx1])],
        jnp.eye(16), train=True, rngs={'dropout': k_d, 'reparam': k_r},
        mutable=['batch_stats'])
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(params=np_tree(state.params),
                bstats=np_tree(state.batch_stats),
                epoch=epoch, vec=np.asarray(vec),
                noise=[np.asarray((z - mu) / (jnp.exp(lv / 2) + 1e-7))
                       for z, mu, lv in zip(zs, mus, logvars)],
                new_params=np_tree(new_params), grads=np_tree(grads),
                new_bs=np_tree(new_bs))


PAIR_KW = dict(epoch_DNN=40, min_epochs=10, batch_size=60, pca_dim=None,
               distance_mode='euclidean', epoch_pd=60, epoch_chunk=20,
               log_pd=1000, log_DNN=1000, use_early_stop=False)


@pytest.fixture(scope='module')
def snap_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp('mesh_snapshots'))


@pytest.fixture(scope='module')
def data_mesh(step_ref, snap_dir, synthetic_pair):
    return cm.spawn_local(_worker_data_mesh, 4, args=(
        step_ref, snap_dir, (synthetic_pair[0], PAIR_KW)))


@pytest.fixture(scope='module')
def model_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp('mesh_model') / 'model.npz')


@pytest.fixture(scope='module')
def mesh_2d(step_ref, model_path):
    return cm.spawn_local(_worker_2d_mesh, 4, mesh_shape=(2, 2),
                          args=(step_ref, model_path))


@pytest.fixture(scope='module')
def jax_mesh():
    from jamie_tpu.core.mesh import create_mesh
    return create_mesh(shape=(8,), axis_names=('data',))


# ------------------------------------------------------- rules, no spawn
def test_param_spec_and_padding_match_jamie_tpu():
    from jax.sharding import PartitionSpec as P
    from jamie_tpu.core import mesh as jm

    for shape in ((2048, 4096), (4096, 2048), (4096,), (32, 64), (4097, 8),
                  (1024, 1024), (1024, 2048, 6), (24, 48), (3, 1024)):
        for n_model in (1, 2, 3, 4, 8):
            for wt in (8, 32, 256, 1024):
                ref = jm.param_spec(shape, n_model, wt)
                ours = cm.param_spec(shape, n_model, wt)
                want = P() if ours is None else P(
                    *[('model' if i == ours else None)
                      for i in range(len(shape))])
                assert ref == want, (shape, n_model, wt, ref, ours)
    # a torch Linear weight is the flax kernel transposed
    assert cm.torch_param_spec((4096, 2048), 2) == 0
    assert cm.torch_param_spec((1024, 1024), 2) == 0    # flax tie -> 'out'
    for rows in (1, 5, 8, 41, 72):
        for n_dev in (1, 2, 3, 8):
            x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
            ref, ref_pad = jm.pad_rows_to_axis(x, n_dev)
            got, pad = cm.pad_rows_to_axis(x, n_dev)
            got_t, pad_t = cm.pad_rows_to_axis(torch.as_tensor(x), n_dev)
            assert pad == pad_t == ref_pad and isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, np.asarray(ref))
            np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref))


def test_create_mesh_errors_and_local_group():
    with pytest.raises(ValueError, match='needs 2 devices, have 1'):
        cm.create_mesh((2,))
    with pytest.raises(ValueError, match='differ in length'):
        cm.create_mesh((1,), ('data', 'model'))
    try:
        mesh = cm.create_mesh((1,), device_type='cpu')
        assert torch.distributed.get_world_size() == 1
        assert cm.axis_size(mesh, 'data') == cm.model_axis_size(mesh) == 1
        assert cm.axis_size(None, 'data') == 1
        from torch.distributed.tensor import Replicate, Shard
        assert cm.data_sharding(mesh) == (Shard(0),)
        assert cm.replicated_sharding(mesh) == (Replicate(),)
        # the mesh path at world size 1: same numbers as the plain path
        x = _distance_input()
        np.testing.assert_array_equal(
            pairwise_distance(x, device='cpu', mesh=mesh).numpy(),
            pairwise_distance(x, device='cpu').numpy())
    finally:
        cm.destroy_group()
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------- 4-rank 'data'
@pytest.mark.parametrize('metric', METRICS)
def test_sharded_distances_match_jamie_tpu(data_mesh, jax_mesh, metric):
    from jamie_tpu.ops.distances import pairwise_distance as jax_pd
    ref = np.asarray(jax_pd(_distance_input(), metric, mesh=jax_mesh))
    for rank in data_mesh:
        np.testing.assert_allclose(rank['distances'][metric], ref, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('precision', ['highest', 'default'])
@pytest.mark.parametrize('case', ['32x32', '37x29'])
def test_sharded_prime_dual_matches_jamie_tpu(data_mesh, jax_mesh, case,
                                              precision):
    from jamie_tpu.solvers.prime_dual import prime_dual as jax_prime_dual
    name, Kx, Ky, dx, dy = next(c for c in _solver_inputs() if c[0] == case)
    ref = np.asarray(jax_prime_dual(Kx, Ky, dx, dy, epoch_pd=100,
                                    verbose=False, precision=precision,
                                    mesh=jax_mesh))
    for rank in data_mesh:
        got = rank['prime_dual'][(case, precision)]
        assert got.shape == Kx.shape[:1] + Ky.shape[:1]
        if precision == 'highest':
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
        else:
            # bf16 operands: test_torch_prime_dual's tolerance for 'default'
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-4 * ref.max())


def test_sharded_solver_state_is_a_quarter(data_mesh):
    for r, rank in enumerate(data_mesh):
        st = rank['state']
        for key in ('F', 'M1', 'M2', 'FKy', 'KxFKy'):
            assert st[key] == (256, 1024), (key, st[key])
        assert st['Mu'] == (256, 1) and st['S'] == st['Lambda'] == (1024, 1)
        assert st['Kx'] == (256, 1024)
        assert rank['state_rows'] == (256 * r, 256, 1024)


def _check_step(ours, ref):
    """test_torch_train.test_one_step_matches_reference's tolerances."""
    import jax
    vec, params, stats, _ = ours
    np.testing.assert_allclose(vec, ref['vec'], rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path
    grads = dict(flat(ref['grads'])[0])
    for (path, r), (_, o) in zip(flat(ref['new_params'])[0],
                                 flat(params)[0]):
        if [p.key for p in path[1:]] == ['TorchDense_0', 'bias']:
            # a BatchNorm-fed bias: an exact gradient of 0, rounding noise
            assert np.abs(grads[path]).max() < 1e-6
            np.testing.assert_array_less(np.abs(o - ref['params'][
                path[0].key]['TorchDense_0']['bias']), 1e-3)
            continue
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-5, err_msg=str(path))
    for (path, r), (_, o) in zip(flat(ref['new_bs'])[0], flat(stats)[0]):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6,
                                   err_msg=str(path))


def test_one_step_data_mesh_matches_jamie_tpu(data_mesh, step_ref):
    for rank in data_mesh:
        _check_step(rank['step'], step_ref)


@pytest.mark.parametrize('case', ['even', 'odd'])
def test_sharded_fit_matches_unsharded(data_mesh, case):
    """Same seed, same random stream: only the summation order of the
    sharded reductions differs."""
    ref = _fit(case, None)
    n = FIT_CASES[case][0]
    padded = -(-n // 4) * 4
    for rank in data_mesh:
        got = rank['fits'][case]
        assert got['rows'] == [padded // 4] * 2
        assert got['embed'][0].shape == (n, 32)
        assert got['corr_shape'] == (n, n)
        np.testing.assert_allclose(got['losses'], ref['losses'], rtol=5e-3,
                                   atol=5e-4)
        for a, b in zip(got['embed'], ref['embed']):
            np.testing.assert_allclose(a, b, atol=5e-2)


def test_auto_mesh_estimator_matches_unsharded(data_mesh):
    rank0 = data_mesh[0]
    assert rank0['auto_mesh'] == {'data': 4}
    assert rank0['plain_mesh'] is None
    for rank in data_mesh:
        for a, b in zip(rank['auto_fit']['embed'], rank['plain_fit']['embed']):
            np.testing.assert_allclose(a, b, rtol=5e-2, atol=5e-3)
        assert abs(rank['auto_fit']['foscttm']
                   - rank['plain_fit']['foscttm']) < 0.02
        # every rank returns the same embeddings
        for a, b in zip(rank['auto_fit']['embed'],
                        rank0['auto_fit']['embed']):
            np.testing.assert_array_equal(a, b)


def test_mesh_snapshot_restores_on_one_process(data_mesh, snap_dir,
                                               synthetic_pair):
    """The auto-mesh fit's last snapshot (written by rank 0 in the
    unsharded layout) restores into a one-process trainer and gives the
    mesh fit's embeddings."""
    snaps = sorted(glob.glob(os.path.join(snap_dir, 'epoch_*')))
    assert [os.path.basename(p) for p in snaps] == ['epoch_20', 'epoch_40']
    one = JAMIE(device='cpu', use_mesh=False,
                **dict(PAIR_KW, epoch_DNN=1))
    one.fit_transform(dataset=synthetic_pair[0])
    state = one.trainer.restore_fit_state(snaps[-1])
    assert state.epoch == 40
    for a, b in zip(one.trainer.final_embed(state),
                    data_mesh[0]['auto_fit']['embed']):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_batch_rows_equal_the_masked_exchange(data_mesh):
    """`_batch_rows` with static shapes gives the buffer of the boolean-mask
    exchange bit for bit for every P and F form, on batches spread over
    the ranks and on batches that leave ranks with no row; an infinite row
    that a rank clamps to and does not own stays out; the guard catches
    the masked exchange."""
    for rank in data_mesh:
        checks = rank['batch_rows']
        assert len(checks) == 15
        for key, c in checks.items():
            assert c['equal'] and c['caught'], key
            assert c['finite'] or c['inf_row'], key
        assert not checks[('dense_dense', 'rank0_only')]['inf_row']


def test_mesh_steps_read_nothing_on_the_host(data_mesh, mesh_2d):
    """One mesh epoch (start, steps, end) of a dense and of a landmark
    form on the ('data',) mesh and of a tensor-parallel trainer on the
    (2, 2) mesh, and every iteration of a mesh prime-dual solve, run under
    _NoHostRead on gloo: the CPU's stand-in for a step that a CUDA graph
    can capture. The guarded solve equals the unguarded one."""
    for rank in data_mesh:
        for name, out in rank['guarded_epochs'].items():
            assert torch.isfinite(out).all(), name
            assert out[6] == 1.0            # the epoch ran
        guarded, plain = rank['guarded_pd']
        assert guarded.shape == (37, 29)
        assert torch.equal(guarded, plain)
    for rank in mesh_2d:
        assert torch.isfinite(rank['guarded_epoch']).all()


def test_mesh_lookahead_equals_sequential_dispatch(data_mesh):
    """dispatch_lookahead=2 on the mesh against sequential dispatch, over
    an early stop inside a chunk: the same epochs, history, prints,
    metrics records and final state on every rank."""
    for rank in data_mesh:
        seq, ahead = rank['lookahead'][0], rank['lookahead'][2]
        assert seq['state'].stopped and seq['run'] % 5 != 0
        for key in ('run', 'history', 'losses', 'prints', 'records'):
            assert seq[key] == ahead[key], key
        a, b = seq['state'], ahead['state']
        for name in ('params', 'mu', 'nu', 'rng'):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        for k in a.batch_stats:
            assert torch.equal(a.batch_stats[k], b.batch_stats[k]), k
        for name in ('count', 'epoch', 'best_running_loss', 'streak'):
            assert getattr(a, name) == getattr(b, name), name
    rank0 = data_mesh[0]['lookahead'][0]
    assert rank0['prints'].count('epoch:[') == rank0['run']
    assert rank0['records'][-1]['epoch_end'] == rank0['run']


# ----------------------------------------------------- (2, 2) data x model
def test_one_step_tensor_parallel_matches_jamie_tpu(mesh_2d, step_ref):
    for rank in mesh_2d:
        assert rank['mesh'] == {'data': 2, 'model': 2}
        # threshold 8 shards every qualifying layer: column- and
        # row-parallel, reduce-scatter and gather between them
        specs = rank['step'][3]
        assert specs['layers.enc0_b0.dense.weight'] == 0
        assert specs['layers.enc0_b1.dense.weight'] == 1
        assert specs['layers.dec0_b1.dense.weight'] == 0
        _check_step(rank['step'], step_ref)


@pytest.mark.parametrize('case', ['tp256', 'tp1024'])
def test_tensor_parallel_splits_and_matches_unsharded(mesh_2d, case):
    """tp_wide_threshold=256 on a 256-feature modality, and the default
    1024 on a 1024-feature one: the (2 f0, f0) encoder kernel, its Adam
    moments and its BatchNorm stats hold half of each on every rank, and
    the fit matches the unsharded fit."""
    n, f0 = FIT_CASES[case][:2]
    ref = _fit(case, None)
    for rank in mesh_2d:
        split = rank[case + '_split']
        assert split['kernel'] == (f0, f0)          # (2 f0, f0) halved
        assert split['bn'] == (f0,)                 # 2 f0 stats halved
        assert split['mu'] < 0.6 * split['whole']   # Adam moments sharded
        np.testing.assert_allclose(rank[case]['losses'], ref['losses'],
                                   rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(rank[case]['embed'][0], ref['embed'][0],
                                   atol=5e-2)


def test_estimator_2d_mesh_through_mesh_shape(mesh_2d, model_path):
    """The tensor-parallel estimator's checkpoint (gathered, written by
    rank 0) loads on one process and predicts what the mesh predicted."""
    est0 = mesh_2d[0]['estimator']
    one = JAMIE(device='cpu').load_model(model_path)
    np.testing.assert_allclose(one.modal_predict(est0['data'][0], 0),
                               est0['predict'], rtol=1e-5, atol=1e-5)
    for rank in mesh_2d:
        est = rank['estimator']
        assert est['mesh'] == {'data': 2, 'model': 2}
        assert est['shape'] == (64, 32) and est['finite']
        assert est['kernel'] == (48, 48)            # (96, 48) over 2 ranks
        assert est['predict'].shape == (64, 16)
        np.testing.assert_array_equal(est['predict'],
                                      mesh_2d[0]['estimator']['predict'])


def test_dryrun_multichip():
    from jamie_tpu_torch.multichip import dryrun_multichip, entry
    out = dryrun_multichip(4)
    assert out['mesh'] == {'data': 2, 'model': 2}
    assert np.isfinite(out['loss'])
    fn, args = entry(device='cpu')
    assert all(bool(torch.isfinite(o).all()) for o in fn(*args))
