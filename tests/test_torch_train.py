"""jamie_tpu_torch.train against jamie_tpu.train on the CPU: the losses
elementwise, the samplers by their properties, and one optimizer step from
the same parameters, indices and noise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as ss
import torch

from jamie_tpu.config import JamieConfig as JConfig
from jamie_tpu.models.coupled_vae import CoupledVAE as FlaxVAE
from jamie_tpu.train import losses as jl
from jamie_tpu.train import sampling as js
from jamie_tpu.train.trainer import JamieTrainer as JTrainer
from jamie_tpu.ops import lowrank as jtl
from jamie_tpu.ops import sparse as jsp
from jamie_tpu_torch.ops.lowrank import from_fields
from jamie_tpu_torch.ops.sparse import SparseRows
from jamie_tpu_torch.config import JamieConfig
from jamie_tpu_torch.models.convert import (load_flax_variables,
                                            to_flax_variables)
from jamie_tpu_torch.models.coupled_vae import CoupledVAE
from jamie_tpu_torch.train import losses as tl
from jamie_tpu_torch.train import sampling as ts
from jamie_tpu_torch.train.trainer import JamieTrainer


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope='module')
def arrays():
    rng = np.random.RandomState(0)
    return {k: rng.randn(16, d).astype(np.float32)
            for k, d in (('a0', 5), ('a1', 5), ('b0', 5), ('b1', 5),
                         ('x0', 7), ('x1', 4), ('r0', 7), ('r1', 4))} | {
        'F': rng.rand(16, 16).astype(np.float32)}


def test_kl_anneal_matches():
    for epoch in (0, 3, 50, 99, 400):
        for min_epochs, epoch_dnn in ((100, 400), (0, 400)):
            assert tl.kl_anneal(epoch, min_epochs, epoch_dnn) == pytest.approx(
                float(jl.kl_anneal(epoch, min_epochs, epoch_dnn)), rel=1e-6)


def test_losses_match(arrays):
    a = arrays
    pairs = [
        (tl.kl_divergence(_t(a['a0'], a['a1']), _t(a['b0'], a['b1'])),
         jl.kl_divergence(_j(a['a0'], a['a1']), _j(a['b0'], a['b1']))),
        (tl.reconstruction_loss(_t(a['x0'], a['x1']), _t(a['r0'], a['r1'])),
         jl.reconstruction_loss(_j(a['x0'], a['x1']), _j(a['r0'], a['r1']))),
        (tl.f_reconstruction_loss(*_t(a['a0'], a['a1'], a['F'])),
         jl.f_reconstruction_loss(*_j(a['a0'], a['a1'], a['F']))),
    ]
    for method in ('euclidean', 'cosine'):
        pairs.append((
            tl.latent_consistency_loss(_t(a['a0'], a['a1']),
                                       _t(a['b0'], a['b1']), method),
            jl.latent_consistency_loss(_j(a['a0'], a['a1']),
                                       _j(a['b0'], a['b1']), method)))
    for ours, ref in pairs:
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    F = a['F'].copy()
    F[3] = 0
    F[:, 5] = 0
    np.testing.assert_allclose(tl.row_normalize(torch.as_tensor(F)).numpy(),
                               np.asarray(jl.row_normalize(jnp.asarray(F))),
                               rtol=1e-6)
    np.testing.assert_allclose(tl.col_normalize(torch.as_tensor(F)).numpy(),
                               np.asarray(jl.col_normalize(jnp.asarray(F))),
                               rtol=1e-6)


@pytest.mark.parametrize('P', [np.eye(6), np.zeros((6, 6)),
                               np.diag([1, 0, 1, 0, 0, 1.0]), np.eye(6, 7)])
def test_detect_sampling_method_matches(P):
    assert ts.detect_sampling_method(P) == js.detect_sampling_method(P)


@pytest.mark.parametrize('method', ['diag', 'zeros'])
def test_epoch_windows_have_no_repeats(method):
    rows, B, L = (100, 100 if method == 'diag' else 90), 16, 5
    sample = ts.make_epoch_sampler(method, rows, B, L)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        idx0, idx1 = sample(gen)
        assert idx0.shape == idx1.shape == (L, B)
        for idx, n in ((idx0, rows[0]), (idx1, rows[1])):
            flat = idx.reshape(-1).numpy()
            assert len(np.unique(flat)) == L * B      # L*B <= n: no wrap
            assert flat.min() >= 0 and flat.max() < n
        if method == 'diag':
            assert torch.equal(idx0, idx1)


def test_hybrid_fraction_matches_true_ratio():
    n, B, L = 500, 64, 200
    pairs = np.stack([np.arange(0, n, 2), (np.arange(0, n, 2) * 7 + 3) % n], 1)
    sample = ts.make_epoch_sampler('hybrid', (n, n), B, L, corr_pairs=pairs,
                                   true_ratio=0.8)
    idx0, idx1 = sample(torch.Generator().manual_seed(1))
    matched = set(map(tuple, pairs))
    hits = np.mean([(i, j) in matched for i, j in
                    zip(idx0.reshape(-1).tolist(), idx1.reshape(-1).tolist())])
    # 12,800 slots: binomial sd 0.0035; chance matches add ~0.2 * 1/n
    assert abs(hits - 0.8) < 0.015


def _setup(batch_step=True, **kw):
    rng = np.random.RandomState(1)
    rows, dims = 40, (12, 9)
    data = [rng.randn(rows, d).astype(np.float32) for d in dims]
    P = np.eye(rows, dtype=np.float32)
    F = rng.rand(rows, rows).astype(np.float32)
    cfg_kw = dict(dropout=0.0, batch_size=16, output_dim=5, epoch_DNN=50,
                  min_epochs=10, batch_step=batch_step, PF_Ratio=0.7, **kw)
    return data, P, F, cfg_kw


def test_one_step_matches_reference():
    data, P, F, cfg_kw = _setup()
    jtr = JTrainer(JConfig(**cfg_kw), FlaxVAE(input_dim=(12, 9), output_dim=5,
                                               dropout=0.0), data, P, F)
    state = jtr.init_state()
    params = jax.tree.map(np.asarray, state.params)
    bstats = jax.tree.map(np.asarray, state.batch_stats)
    idx0 = np.array([3, 17, 8, 0, 25, 39, 11, 30, 5, 21, 14, 2, 33, 7, 19, 28])
    idx1 = np.roll(idx0, 3)
    epoch, key = 12, jax.random.PRNGKey(9)

    # jamie_tpu: one batch's loss and grads, then clip + Adam
    ops = jtr._operands()
    _, vec, new_bs, grads = jtr._batch_loss_and_grads(
        state.params, state.batch_stats, key, epoch, ops, jnp.asarray(idx0),
        jnp.asarray(idx1))
    updates, _ = jtr.tx.update(grads, state.opt_state, state.params)
    ref_params = optax.apply_updates(state.params, updates)

    # the reparameterization noise that step drew, recovered from the same
    # forward (the key split of _batch_loss_and_grads)
    k_d, k_r = jax.random.split(key)
    (zs, _, _, mus, logvars), _ = jtr.model.apply(
        {'params': state.params, 'batch_stats': state.batch_stats},
        [jnp.asarray(data[0][idx0]), jnp.asarray(data[1][idx1])],
        jnp.eye(16), train=True, rngs={'dropout': k_d, 'reparam': k_r},
        mutable=['batch_stats'])
    noise = [torch.as_tensor(np.asarray((z - mu) / (jnp.exp(lv / 2) + 1e-7)))
             for z, mu, lv in zip(zs, mus, logvars)]

    model = CoupledVAE((12, 9), 5, dropout=0.0)
    load_flax_variables(model, params, bstats)
    tr = JamieTrainer(JamieConfig(**cfg_kw), model, data, P, F, device='cpu')
    _, ours_vec = tr.train_step(torch.as_tensor(idx0), torch.as_tensor(idx1),
                                epoch, noise=noise)
    np.testing.assert_allclose(ours_vec.numpy(), np.asarray(vec), rtol=1e-5)
    ours_params, ours_stats = to_flax_variables(model)
    flat = jax.tree_util.tree_flatten_with_path
    ref_grads = dict(flat(jax.tree.map(np.asarray, grads))[0])
    for (path, r), (_, o) in zip(flat(jax.tree.map(np.asarray, ref_params))[0],
                                 flat(ours_params)[0]):
        if [p.key for p in path[1:]] == ['TorchDense_0', 'bias']:
            # A dense bias that feeds a BatchNorm has an exact gradient of 0
            # (the batch mean is subtracted right after it), so both
            # packages hold f32 rounding noise there, and Adam's first step
            # g / (|g| + 1e-8) scales that noise to a fraction of lr.
            # Check that it is noise in the reference and that the port's
            # step stays below lr.
            assert np.abs(ref_grads[path]).max() < 1e-6
            np.testing.assert_array_less(np.abs(o - params[path[0].key][
                'TorchDense_0']['bias']), cfg_kw.get('model_lr', 1e-3))
            continue
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-5, err_msg=str(path))
    for (path, r), (_, o) in zip(flat(jax.tree.map(np.asarray, new_bs))[0],
                                 flat(ours_stats)[0]):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6,
                                   err_msg=str(path))


@pytest.mark.parametrize('batch_step', [True, False])
def test_fit_runs_and_early_stops(batch_step):
    data, P, F, cfg_kw = _setup(batch_step, max_steps_without_increment=2,
                                min_increment=1e9)
    model = CoupledVAE((12, 9), 5, dropout=0.0)
    tr = JamieTrainer(JamieConfig(**cfg_kw), model, data, P, F, device='cpu')
    tr.fit()
    # the first epoch past min_epochs improves on the initial inf; none after
    # it can improve by 1e9, so the streak reaches 2 two epochs later and
    # the fit stops at 0-based epoch min_epochs + 3
    assert tr.epochs_run == cfg_kw['min_epochs'] + 4
    assert all(len(v) == tr.epochs_run for v in tr.loss_history.values())
    emb = tr.final_embed()
    assert emb[0].shape == (40, 5) and np.isfinite(emb[0]).all()


def test_unported_priors_raise():
    """Every P/F form of jamie_tpu's trainer is ported: the sentinels and a
    1-D mask build, and what is malformed raises ValueError (an unknown
    sentinel, a prior of the wrong shape, 'identity' for unequal rows)."""
    data, P, F, cfg_kw = _setup()
    for good_P, good_F in (('identity', F), (np.ones(40), F), (P, 'zeros')):
        JamieTrainer(JamieConfig(**cfg_kw), CoupledVAE((12, 9), 5), data,
                     good_P, good_F, device='cpu')
    unequal = [data[0], data[1][:30]]
    for bad_data, bad_P, bad_F in (
            (data, 'eye', F), (data, P, 'identity'), (data, P[:30], F),
            (data, P, SparseRows.from_dense(F[:, :30])),
            (unequal, 'identity', 'zeros'), (unequal, np.ones(40), 'zeros')):
        with pytest.raises(ValueError):
            JamieTrainer(JamieConfig(**cfg_kw), CoupledVAE((12, 9), 5),
                         bad_data, bad_P, bad_F, device='cpu')


# ---------------------------------------------------------------- P/F forms
N = 40
_rng = np.random.RandomState(21)
MASK = (_rng.rand(N) < 0.5).astype(np.float32)
P_SPARSE = np.where(_rng.rand(N, N) < 0.08, _rng.rand(N, N), 0).astype(
    np.float32)
F_DENSE = _rng.rand(N, N).astype(np.float32)
F_SPARSE = np.where(_rng.rand(N, N) < 0.15, F_DENSE, 0).astype(np.float32)
_LM = (np.stack([_rng.choice(10, 3, replace=False) for _ in range(N)]),
       _rng.rand(N, 3).astype(np.float32),
       np.stack([_rng.choice(12, 3, replace=False) for _ in range(N)]),
       _rng.rand(N, 3).astype(np.float32), _rng.rand(10, 12).astype(np.float32))


def _p_form(name):
    """(the form both trainers take, or None where jamie_tpu takes the
    same object; the dense equivalent)."""
    r, c = np.nonzero(P_SPARSE)
    return {
        'dense': (None, np.eye(N, dtype=np.float32)),
        'identity': ('identity', np.eye(N, dtype=np.float32)),
        'mask': (MASK, np.diag(MASK)),
        'mask_ones': (np.ones(N, np.float32), np.eye(N, dtype=np.float32)),
        'mask_zeros': (np.zeros(N, np.float32), np.zeros((N, N), np.float32)),
        'sparse_rows': ('SparseRows', P_SPARSE),
        'scipy': (ss.csr_matrix(P_SPARSE), P_SPARSE),
        'coo': ((r, c, P_SPARSE[r, c], (N, N)), P_SPARSE),
        'sparse_empty': ('SparseRows', np.zeros((N, N), np.float32)),
        'sparse_eye': ('SparseRows', np.eye(N, dtype=np.float32)),
        'sparse_half_eye': ('SparseRows', 0.5 * np.eye(N, dtype=np.float32)),
    }[name]


def _f_form(name):
    sp = jtl.SparseLandmarkF(*_LM)
    lr = jtl.LowRankF(np.asarray(sp.u), np.asarray(sp.v))
    return {
        'dense': (None, F_DENSE),
        'zeros': ('zeros', np.zeros((N, N), np.float32)),
        'sparse_rows': ('SparseRows', F_SPARSE),
        'lowrank': (lr, lr.to_dense()),
        'sparse_landmark': (sp, sp.to_dense()),
    }[name]


def _forms(p_name, f_name):
    """((our P, our F), (jamie_tpu's P, F)) in the named forms."""
    out = []
    for (form, dense) in (_p_form(p_name), _f_form(f_name)):
        if form is None:
            out.append((dense, dense))
        elif isinstance(form, str) and form == 'SparseRows':
            out.append((SparseRows.from_dense(dense),
                        jsp.SparseRows.from_dense(dense)))
        elif isinstance(form, jtl.LowRankF):
            out.append((from_fields(form, device='cpu'), form))
        else:
            out.append((form, form))
    return tuple(zip(*out))


P_FORMS = ['dense', 'identity', 'mask', 'mask_ones', 'mask_zeros',
           'sparse_rows', 'scipy', 'coo', 'sparse_empty', 'sparse_eye',
           'sparse_half_eye']
F_FORMS = ['dense', 'zeros', 'sparse_rows', 'lowrank', 'sparse_landmark']


def _trainers(p_name, f_name, **kw):
    data, _, _, cfg_kw = _setup(**kw)
    (P, F), (jP, jF) = _forms(p_name, f_name)
    jtr = JTrainer(JConfig(**cfg_kw), FlaxVAE(input_dim=(12, 9), output_dim=5,
                                               dropout=0.0), data, jP, jF)
    tr = JamieTrainer(JamieConfig(**cfg_kw), CoupledVAE((12, 9), 5,
                                                        dropout=0.0),
                      data, P, F, device='cpu')
    return jtr, tr, data, cfg_kw


@pytest.mark.parametrize('p_name', P_FORMS)
def test_sampling_regime_per_form(p_name):
    """The regime (and the matched-pair table of 'hybrid') follows P's
    form as in jamie_tpu: a zero-nnz sparse P selects 'zeros', a diagonal
    sparse P with unit row sums 'diag', a mask of all ones 'diag', any
    other positive mask 'hybrid' on its nonzero pairs."""
    jtr, tr, _, _ = _trainers(p_name, 'zeros')
    assert tr.sampling_method == jtr.sampling_method
    expect = {'dense': 'diag', 'identity': 'diag', 'mask_ones': 'diag',
              'sparse_eye': 'diag', 'mask_zeros': 'zeros',
              'sparse_empty': 'zeros'}.get(p_name, 'hybrid')
    assert tr.sampling_method == expect
    _, pairs = tr._sampling_regime()
    if expect == 'hybrid':
        np.testing.assert_array_equal(pairs, np.asarray(jtr._pairs))
    else:
        assert pairs is None


def _reference_batch(jtr, data, idx0, idx1, epoch=12, seed=9):
    """jamie_tpu's loss vector for one batch, the flax variables it used,
    and the reparameterization noise it drew."""
    state = jtr.init_state()
    key = jax.random.PRNGKey(seed)
    _, vec, _, _ = jtr._batch_loss_and_grads(
        state.params, state.batch_stats, key, epoch, jtr._operands(),
        jnp.asarray(idx0), jnp.asarray(idx1))
    k_d, k_r = jax.random.split(key)
    (zs, _, _, mus, logvars), _ = jtr.model.apply(
        {'params': state.params, 'batch_stats': state.batch_stats},
        [jnp.asarray(data[0][idx0]), jnp.asarray(data[1][idx1])],
        jnp.eye(len(idx0)), train=True,
        rngs={'dropout': k_d, 'reparam': k_r}, mutable=['batch_stats'])
    noise = [torch.as_tensor(np.asarray((z - mu) / (jnp.exp(lv / 2) + 1e-7)))
             for z, mu, lv in zip(zs, mus, logvars)]
    return (np.asarray(vec), jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats), noise)


@pytest.mark.parametrize('p_name, f_name', [
    *((p, 'dense') for p in ('identity', 'mask', 'sparse_rows', 'scipy',
                             'coo')),
    *(('dense', f) for f in ('zeros', 'sparse_rows', 'lowrank',
                             'sparse_landmark')),
    ('identity', 'sparse_landmark'), ('sparse_rows', 'lowrank')])
def test_batch_loss_per_form(p_name, f_name):
    """One batch's loss vector with P and F in each form, held to
    jamie_tpu's loss on the dense-equivalent P and F (same parameters,
    indices with duplicates, and noise) at rtol 1e-5; the batch blocks
    themselves to the dense blocks at 1e-6."""
    data, _, _, cfg_kw = _setup()
    (P, F), _ = _forms(p_name, f_name)
    _, P_dense = _p_form(p_name)
    _, F_dense = _f_form(f_name)
    jtr = JTrainer(JConfig(**cfg_kw), FlaxVAE(input_dim=(12, 9), output_dim=5,
                                               dropout=0.0), data, P_dense,
                   F_dense)
    idx0 = np.array([3, 17, 8, 0, 25, 39, 11, 30, 5, 21, 14, 3, 33, 7, 19, 5])
    idx1 = idx0 if p_name == 'identity' else np.roll(idx0, 3)
    idx1 = np.where(np.arange(16) % 5 == 0, idx0, idx1)   # some true pairs
    vec, params, bstats, noise = _reference_batch(jtr, data, idx0, idx1)

    model = CoupledVAE((12, 9), 5, dropout=0.0)
    load_flax_variables(model, params, bstats)
    tr = JamieTrainer(JamieConfig(**cfg_kw), model, data, P, F, device='cpu')
    i0, i1 = torch.as_tensor(idx0), torch.as_tensor(idx1)
    np.testing.assert_allclose(tr._p_sub(i0, i1).numpy(),
                               P_dense[np.ix_(idx0, idx1)], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tr._f_sub(i0, i1).numpy(),
                               F_dense[np.ix_(idx0, idx1)], rtol=1e-6,
                               atol=1e-7)
    tr.model.train()
    _, ours = tr.batch_loss(i0, i1, 12, noise=noise)
    np.testing.assert_allclose(ours.detach().numpy(), vec, rtol=1e-5)


def _summed_dense(sr):
    """Float64 dense build of a SparseRows' slots, duplicates summed."""
    out = np.zeros(sr.shape)
    rows = np.repeat(np.arange(sr.shape[0]), sr.cols.shape[1])
    keep = sr.cols.ravel() >= 0
    np.add.at(out, (rows[keep], sr.cols.ravel()[keep]),
              sr.vals.ravel()[keep].astype(np.float64))
    return out


@pytest.mark.parametrize('budget', [50_000_000, 100])
@pytest.mark.parametrize('p_name, f_name', [
    ('dense', 'dense'), ('identity', 'zeros'), ('mask', 'sparse_rows'),
    ('sparse_rows', 'zeros'), ('identity', 'lowrank'),
    ('mask', 'sparse_landmark'), ('dense', 'lowrank')])
def test_final_corr_per_form(p_name, f_name, budget):
    """final_corr against jamie_tpu's on the same forms, within and past
    its dense budget (past it, sparse-form P and F combine as SparseRows
    and a low-rank F is compressed to its per-row top-k first): rtol 1e-5
    of float32 column normalization."""
    jtr, tr, _, _ = _trainers(p_name, f_name)
    ours = tr.final_corr(max_dense_entries=budget)
    ref = jtr.final_corr(max_dense_entries=budget)
    assert isinstance(ours, SparseRows) == isinstance(ref, jsp.SparseRows)
    if isinstance(ours, SparseRows):
        assert budget == 100 and f_name != 'dense' and p_name != 'dense'
        # P's identity/mask slots and F's top-k slots share the diagonal:
        # both sides are built by summing their slots (jamie_tpu's to_dense
        # keeps only the last of them, ROADMAP.md Queue 3)
        np.testing.assert_allclose(ours.to_dense(), _summed_dense(ours),
                                   rtol=1e-6, atol=0)
        ours, ref = _summed_dense(ours), _summed_dense(ref)
    else:
        ours, ref = ours.numpy(), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('layout', ['lowrank', 'sparse_landmark'])
def test_fit_with_factorized_f_matches_dense_f(layout):
    """A fit with F factorized matches the same fit with the dense F (same
    generator, so the same batches): the epoch losses within rtol 1e-4 of
    float32 summation order compounded over 10 epochs."""
    data, P, _, cfg_kw = _setup()
    cfg_kw.update(epoch_DNN=10, use_early_stop=False)
    (_, F), _ = _forms('dense', layout)
    losses = []
    for f in (F, F.to_dense()):
        tr = JamieTrainer(JamieConfig(**cfg_kw), CoupledVAE(
            (12, 9), 5, dropout=0.0, seed=3), data, P, f, device='cpu')
        tr.fit()
        losses.append(tr.epoch_losses)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-6)


def test_bf16_compute_step_matches_reference():
    """compute_dtype bfloat16 in both packages (f32 parameters, bf16
    activations), one batch from the same parameters and indices, with the
    same bf16 reparameterization noise injected into both (jamie_tpu's
    draw replaced for the step). Measured on this input: the loss vector
    agrees exactly (held at rtol 1e-5). The backward rounds to bf16 in
    another order; measured ||dg|| / ||g|| per tensor: median 3.5e-3,
    worst 0.19 (dec0_b0, whose batch sums cancel), held at 0.25, except the
    dense biases that feed a BatchNorm, whose exact gradient is 0 (both
    hold bf16 rounding noise there). Adam's first step moves each entry
    by about lr * sign(g), so the updated parameters agree to f32 rounding
    where the gradients' signs agree (measured: 2406 of the 2410 entries
    outside those biases), held on 99%, every entry within 2 lr."""
    from unittest import mock
    data, P, F, cfg_kw = _setup()
    cfg_kw['compute_dtype'] = 'bfloat16'
    jtr = JTrainer(JConfig(**cfg_kw), FlaxVAE(
        input_dim=(12, 9), output_dim=5, dropout=0.0,
        compute_dtype=jnp.bfloat16), data, P, F)
    state = jtr.init_state()
    params = jax.tree.map(np.asarray, state.params)
    bstats = jax.tree.map(np.asarray, state.batch_stats)
    idx0 = np.array([3, 17, 8, 0, 25, 39, 11, 30, 5, 21, 14, 2, 33, 7, 19, 28])
    idx1 = np.roll(idx0, 3)
    rng = np.random.RandomState(5)
    noise = [jnp.asarray(rng.randn(16, 5), jnp.bfloat16) for _ in range(2)]
    drawn = []

    def injected_normal(key, shape, dtype=jnp.float32):
        out = noise[len(drawn)]           # modality 0, then modality 1
        drawn.append(key)
        assert out.shape == tuple(shape) and out.dtype == dtype
        return out

    with mock.patch.object(jax.random, 'normal', injected_normal):
        _, vec, _, grads = jtr._batch_loss_and_grads(
            state.params, state.batch_stats, jax.random.PRNGKey(9), 12,
            jtr._operands(), jnp.asarray(idx0), jnp.asarray(idx1))
    assert len(drawn) == 2
    updates, _ = jtr.tx.update(grads, state.opt_state, state.params)
    ref_params = optax.apply_updates(state.params, updates)

    model = CoupledVAE((12, 9), 5, dropout=0.0, compute_dtype=torch.bfloat16)
    load_flax_variables(model, params, bstats)
    tr = JamieTrainer(JamieConfig(**cfg_kw), model, data, P, F, device='cpu')
    tr.model.train()
    loss, ours_vec = tr.batch_loss(
        torch.as_tensor(idx0), torch.as_tensor(idx1), 12,
        noise=[torch.as_tensor(np.asarray(n, np.float32)).bfloat16()
               for n in noise])
    assert ours_vec.dtype == torch.float32
    np.testing.assert_allclose(ours_vec.detach().numpy(), np.asarray(vec),
                               rtol=1e-5)
    loss.backward()
    ours_grads = _flax_tree_of_grads(model)
    tr.optimizer.step()
    ours_params, _ = to_flax_variables(model)
    flat = jax.tree_util.tree_flatten_with_path
    lr = cfg_kw.get('model_lr', 1e-3)
    agree = total = 0
    for (path, r), (_, o), (_, g), (_, og) in zip(
            flat(jax.tree.map(np.asarray, ref_params))[0],
            flat(ours_params)[0],
            flat(jax.tree.map(np.asarray, grads))[0],
            flat(ours_grads)[0]):
        np.testing.assert_array_less(np.abs(o - r), 2 * lr + 1e-6)
        if [p.key for p in path[1:]] == ['TorchDense_0', 'bias']:
            continue
        rel = np.linalg.norm(og - g) / np.linalg.norm(g)
        assert rel <= 0.25, (path, rel)
        agree += int(np.sum(np.abs(o - r) <= 1e-6))
        total += r.size
    assert agree >= 0.99 * total, (agree, total)


def _flax_tree_of_grads(model):
    """The port's parameter gradients in flax's tree layout."""
    saved = [p.data for p in model.parameters()]
    for p in model.parameters():
        p.data = p.grad
    try:
        return to_flax_variables(model)[0]
    finally:
        for p, d in zip(model.parameters(), saved):
            p.data = d
