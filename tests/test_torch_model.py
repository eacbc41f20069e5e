"""jamie_tpu_torch.models against jamie_tpu's flax CoupledVAE on the CPU,
with the flax variables carried across by models/convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamie_tpu.models.coupled_vae import CoupledVAE as FlaxVAE
from jamie_tpu_torch.models.convert import (load_flax_variables,
                                            to_flax_variables)
from jamie_tpu_torch.models.coupled_vae import CoupledVAE

DIMS, OUT, B = (12, 9), 5, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def pair():
    """A flax model with perturbed (non-trivial) batch stats, its torch
    twin, and one batch of inputs."""
    fm = FlaxVAE(input_dim=DIMS, output_dim=OUT, dropout=0.0)
    rngs = {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1),
            'reparam': jax.random.PRNGKey(2)}
    rng = np.random.RandomState(0)
    xs = [rng.randn(B, d).astype(np.float32) for d in DIMS]
    corr = rng.rand(B, B).astype(np.float32)
    variables = fm.init(rngs, [jnp.asarray(x) for x in xs], jnp.asarray(corr),
                        train=True)
    variables = _np_tree(variables)
    stats = jax.tree.map(lambda a: a + rng.rand(*a.shape).astype(np.float32),
                         variables['batch_stats'])
    variables = {'params': variables['params'], 'batch_stats': stats}
    tm = CoupledVAE(DIMS, OUT, dropout=0.0)
    load_flax_variables(tm, variables['params'], variables['batch_stats'])
    return fm, variables, tm, xs, corr


def _flax_forward(fm, variables, xs, corr, train, key=3):
    rngs = {'dropout': jax.random.PRNGKey(key),
            'reparam': jax.random.PRNGKey(key + 1)}
    out, mutated = fm.apply(variables, [jnp.asarray(x) for x in xs],
                            jnp.asarray(corr), train=train, rngs=rngs,
                            mutable=['batch_stats'])
    return _np_tree(out), _np_tree(mutated.get('batch_stats', {}))


def _compare_outputs(ours, ref):
    for o_list, r_list in zip(ours, ref):   # zs, combined, x_hat, mus, logvars
        for o, r in zip(o_list, r_list):
            np.testing.assert_allclose(o.detach().numpy(), r, **TOL)


def test_variables_round_trip(pair):
    fm, variables, tm, *_ = pair
    params, stats = to_flax_variables(tm)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (pa, a), (pb, b) in zip(flat(params), flat(variables['params'])):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    for (pa, a), (pb, b) in zip(flat(stats), flat(variables['batch_stats'])):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_eval_forward_matches(pair):
    fm, variables, tm, xs, corr = pair
    ref, _ = _flax_forward(fm, variables, xs, corr, train=False)
    tm.eval()
    with torch.no_grad():
        ours = tm([torch.as_tensor(x) for x in xs], torch.as_tensor(corr))
    _compare_outputs(ours, ref)


def test_train_forward_and_running_stats_match(pair):
    """Dropout 0 and the reparameterization noise recovered from the flax
    forward, eps = (z - mu) / (exp(logvar / 2) + 1e-7); then the running
    stats after one train forward (flax: biased batch variance)."""
    fm, variables, _, xs, corr = pair
    tm = CoupledVAE(DIMS, OUT, dropout=0.0)
    load_flax_variables(tm, variables['params'], variables['batch_stats'])
    ref, new_stats = _flax_forward(fm, variables, xs, corr, train=True)
    zs, _, _, mus, logvars = ref
    noise = [torch.as_tensor((z - mu) / (np.exp(lv / 2) + 1e-7))
             for z, mu, lv in zip(zs, mus, logvars)]
    tm.train()
    ours = tm([torch.as_tensor(x) for x in xs], torch.as_tensor(corr),
              noise=noise)
    _compare_outputs(ours, ref)
    _, stats = to_flax_variables(tm)
    for path, r in jax.tree_util.tree_flatten_with_path(new_stats)[0]:
        keys = [p.key for p in path]
        o = stats
        for k in keys:
            o = o[k]
        np.testing.assert_allclose(o, r, **TOL)


def test_impute_and_embed_one_match(pair):
    fm, variables, tm, xs, _ = pair
    tm.eval()
    for i, j in ((0, 1), (1, 0)):
        ref = np.asarray(fm.apply(variables, jnp.asarray(xs[i]), i, j,
                                  train=False, method=FlaxVAE.impute))
        with torch.no_grad():
            ours = tm.impute(torch.as_tensor(xs[i]), i, j).numpy()
        np.testing.assert_allclose(ours, ref, **TOL)
        ref = np.asarray(fm.apply(variables, jnp.asarray(xs[i]), i,
                                  train=False, method=FlaxVAE.embed_one))
        with torch.no_grad():
            ours = tm.embed_one(torch.as_tensor(xs[i]), i).numpy()
        np.testing.assert_allclose(ours, ref, **TOL)


def test_matmul_bf16_eval_matches(pair):
    """bf16 operands with an f32 result in both: the products are exact in
    f32, so only the summation order differs."""
    _, variables, _, xs, corr = pair
    fm = FlaxVAE(input_dim=DIMS, output_dim=OUT, dropout=0.0,
                 matmul_bf16=True)
    tm = CoupledVAE(DIMS, OUT, dropout=0.0, matmul_bf16=True).eval()
    load_flax_variables(tm, variables['params'], variables['batch_stats'])
    ref, _ = _flax_forward(fm, variables, xs, corr, train=False)
    with torch.no_grad():
        ours = tm([torch.as_tensor(x) for x in xs], torch.as_tensor(corr))
    _compare_outputs(ours, ref)


def test_default_dropout_and_init_bounds():
    assert CoupledVAE((65, 3), 2).dropout_rate == 0.6
    assert CoupledVAE((64, 3), 2).dropout_rate == 0.0
    m = CoupledVAE((40, 10), 4, seed=1)
    w = m.layers['enc0_b0'].dense.weight.detach()
    assert w.shape == (80, 40) and float(w.abs().max()) <= 1 / np.sqrt(40)
    sigma = m.sigma.detach()
    assert 0.0 <= float(sigma.min()) and float(sigma.max()) < 1.0


def test_dropout_draws_from_the_generator():
    m = CoupledVAE((80, 70), 4).train()
    x = [torch.ones(8, 80), torch.ones(8, 70)]
    corr = torch.eye(8)
    outs = [m(x, corr, generator=torch.Generator().manual_seed(s))[0][0]
            for s in (5, 5, 6)]
    torch.testing.assert_close(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2])


# bf16 compute: flax and torch round the same bf16 operations in other
# orders (matmul accumulation, the bias add, the BatchNorm cast); measured
# on this input, every output within 2.4e-3 of its largest entry in eval
# mode and 6.2e-3 in train mode. Held at 1e-2 of each output's max.
BF16_TOL = 1e-2


def _close_bf16(ours, ref):
    o, r = ours.detach().float().numpy(), np.asarray(ref, np.float32)
    assert o.shape == r.shape
    np.testing.assert_array_less(np.abs(o - r), BF16_TOL * np.abs(r).max()
                                 + 1e-30)


@pytest.mark.parametrize('train', [False, True])
def test_bf16_compute_forward_matches(pair, train):
    """compute_dtype bfloat16 against flax's: bf16 activations, f32
    parameters and running stats, combined latents promoted to f32 with
    sigma, as in jax. Train mode draws the same bf16 noise in both
    (jamie_tpu's draw replaced) and updates the f32 running stats alike."""
    from unittest import mock
    _, variables, _, xs, corr = pair
    fm = FlaxVAE(input_dim=DIMS, output_dim=OUT, dropout=0.0,
                 compute_dtype=jnp.bfloat16)
    tm = CoupledVAE(DIMS, OUT, dropout=0.0, compute_dtype=torch.bfloat16)
    load_flax_variables(tm, variables['params'], variables['batch_stats'])
    rng = np.random.RandomState(8)
    noise = [jnp.asarray(rng.randn(B, OUT), jnp.bfloat16) for _ in DIMS]
    drawn = []

    def injected_normal(key, shape, dtype=jnp.float32):
        drawn.append(key)
        return noise[len(drawn) - 1]

    with mock.patch.object(jax.random, 'normal', injected_normal):
        ref, new_stats = _flax_forward(fm, variables, xs, corr, train=train)
    assert len(drawn) == (2 if train else 0)
    tm.train(train)
    with torch.no_grad():
        ours = tm([torch.as_tensor(x) for x in xs], torch.as_tensor(corr),
                  noise=[torch.as_tensor(np.asarray(n, np.float32))
                         for n in noise])
    dtypes = [o.dtype for o in ours[1]]
    assert dtypes == [torch.float32] * 2            # combined, as in jax
    assert ours[0][0].dtype == ours[2][0].dtype == torch.bfloat16
    for o_list, r_list in zip(ours, ref):
        for o, r in zip(o_list, r_list):
            _close_bf16(o, r)
    if train:
        _, stats = to_flax_variables(tm)
        for path, r in jax.tree_util.tree_flatten_with_path(new_stats)[0]:
            o = stats
            for k in [p.key for p in path]:
                o = o[k]
            assert o.dtype == np.float32
            np.testing.assert_allclose(o, r, rtol=BF16_TOL, atol=1e-6)


def test_bf16_compute_impute_and_embed_match(pair):
    _, variables, _, xs, _ = pair
    fm = FlaxVAE(input_dim=DIMS, output_dim=OUT, dropout=0.0,
                 compute_dtype=jnp.bfloat16, matmul_bf16=True)
    tm = CoupledVAE(DIMS, OUT, dropout=0.0, compute_dtype=torch.bfloat16,
                    matmul_bf16=True).eval()
    load_flax_variables(tm, variables['params'], variables['batch_stats'])
    for i, j in ((0, 1), (1, 0)):
        with torch.no_grad():
            _close_bf16(tm.impute(torch.as_tensor(xs[i]), i, j),
                        fm.apply(variables, jnp.asarray(xs[i]), i, j,
                                 train=False, method=FlaxVAE.impute))
            _close_bf16(tm.embed_one(torch.as_tensor(xs[i]), i),
                        fm.apply(variables, jnp.asarray(xs[i]), i,
                                 train=False, method=FlaxVAE.embed_one))


def test_bf16_checkpoint_from_reference_serves(synthetic_pair, tmp_path):
    """A compute_bf16 checkpoint written by jamie_tpu loads in the port as
    a bf16 model and serves the same modal_predict and transform_one. The
    inputs pass the float32 preclass first, whose last-bit differences can
    flip a bf16 rounding that the layers carry on: measured worst
    1.1e-2 of an output's largest entry (2.5 bf16 ulps of a latent), held
    at 2e-2."""
    from jamie_tpu import JAMIE as JaxJAMIE
    from jamie_tpu_torch import JAMIE
    data, _ = synthetic_pair
    jj = JaxJAMIE(use_mesh=False, compute_dtype='bfloat16', epoch_DNN=30,
                  min_epochs=10, epoch_chunk=30, batch_size=64,
                  pca_dim=(16, 12), use_f_tilde=False, use_early_stop=False,
                  dropout=0.0, log_DNN=10_000)
    jj.fit_transform(dataset=data)
    path = str(tmp_path / 'bf16.npz')
    jj.save_model(path)
    tj = JAMIE(device='cpu').load_model(path)
    assert tj.model.compute_dtype == torch.bfloat16
    for m in (0, 1):
        for ours, ref in ((tj.modal_predict(data[m], m),
                           jj.modal_predict(data[m], m)),
                          (tj.transform_one(data[m], m),
                           jj.transform_one(data[m], m))):
            assert ours.dtype == np.float32
            ref = np.asarray(ref, np.float32)
            np.testing.assert_array_less(np.abs(ours - ref),
                                         2e-2 * np.abs(ref).max())


# ------------------------------------------ the block tail (ops/block_tail)
BLOCK_CASES = [(case, dtype) for case in ('dropout0', 'dropout0.6',
                                          'constant_column', 'ragged_rows')
               for dtype in (torch.float64, torch.float32)] + [
    (case, torch.bfloat16) for case in ('dropout0', 'dropout0.6')]


def _tail_pair(case, dtype):
    """A train-mode _Block with non-trivial BatchNorm parameters and
    running stats, a deep copy, an input and an output gradient. 37 rows
    for 'ragged_rows' (no multiple of any row tile), a column whose Linear
    output is its bias alone for 'constant_column' (variance 0; at 0.1
    float32 rounds E[u^2] - E[u]^2 below 0, so the clip cuts the variance
    branch of the gradient, where float64 reads 0 and keeps it); a bf16
    input keeps f32 parameters (compute_dtype bfloat16)."""
    import copy
    from jamie_tpu_torch.models.coupled_vae import _Block
    gen = torch.Generator().manual_seed(4)
    B = 37 if case == 'ragged_rows' else 64
    blk = _Block(24, 40, 0.6 if case == 'dropout0.6' else 0.0, False, gen)
    with torch.no_grad():
        blk.bn.weight.uniform_(0.5, 1.5, generator=gen)
        blk.bn.bias.uniform_(-0.5, 0.5, generator=gen)
        blk.bn.running_mean.uniform_(-1, 1, generator=gen)
        blk.bn.running_var.uniform_(0.5, 2, generator=gen)
        if case == 'constant_column':
            blk.dense.weight[3] = 0.0
            blk.dense.bias[3] = 0.1
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    blk = blk.to(pdt).train()
    x = torch.randn(B, 24, generator=gen, dtype=pdt).to(dtype)
    gy = torch.randn(B, 40, generator=gen, dtype=pdt).to(dtype)
    return blk, copy.deepcopy(blk), x, gy


def _tail_run(blk, x, gy, fused):
    """Output, running stats and every gradient of one train step of the
    block (fused: through `_Block.fused`, here the autograd Function with
    the kernels' plain versions), and the gradient at the Linear's output
    (read by a hook)."""
    x = x.clone().requires_grad_(True)
    du = []

    def keep_grad(module, inputs, out):
        out.register_hook(du.append)
    hook = blk.dense.register_forward_hook(keep_grad)
    gen = torch.Generator().manual_seed(11)
    y = blk.fused(x, gen) if fused else blk(x, gen)
    hook.remove()
    y.backward(gy)
    out = {'y': y, 'running_mean': blk.bn.running_mean,
           'running_var': blk.bn.running_var, 'dx': x.grad,
           'dW': blk.dense.weight.grad, 'dlin_bias': blk.dense.bias.grad,
           'dscale': blk.bn.weight.grad, 'dbias': blk.bn.bias.grad}
    return {k: v.detach() for k, v in out.items()}, du


@pytest.mark.parametrize('case,dtype', BLOCK_CASES,
                         ids=lambda v: str(v).replace('torch.', ''))
def test_block_tail_matches_composed_block(case, dtype):
    """The block tail's arithmetic (`ops/block_tail.py`'s plain versions,
    which the kernels repeat) through its autograd Function against
    autograd of the composed _Block, at the same dropout mask: output,
    running stats, dx, dW and the four gradients of the tail. float64
    within 1e-12 and float32 within 1e-6 of each reference's largest entry
    (summation orders differ); the Linear bias's gradient, a sum of the
    Linear output's gradient that cancels to ~0, within that share of the
    largest column sum of its magnitude. bf16 (f32 statistics, rounded
    to bf16 where the composed ops round) within the same 1e-6."""
    blk, twin, x, gy = _tail_pair(case, dtype)
    rv0 = blk.bn.running_var.clone()
    want, du = _tail_run(blk, x, gy, fused=False)
    got, _ = _tail_run(twin, x, gy, fused=True)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        scale = (float(du[0].abs().sum(0).max()) if k == 'dlin_bias'
                 else float(w.abs().max()))
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * scale, (k, err, scale)
    if case == 'dropout0.6':
        dropped = want['y'] == 0
        assert 0.4 < float(dropped.double().mean()) < 0.8
        assert torch.equal(got['y'] == 0, dropped)
    if case == 'constant_column':   # the batch variance is 0 there
        for out in (want, got):
            assert float(out['running_var'][3]) == pytest.approx(
                0.9 * float(rv0[3]), rel=1e-6)
        from jamie_tpu_torch.ops.block_tail import block_tail_forward_plain
        bn = twin.bn
        with torch.no_grad():
            _, stats = block_tail_forward_plain(
                twin.dense.product(x), twin.dense.bias, bn.weight, bn.bias,
                bn.running_mean.clone(), bn.running_var.clone(), None, 1.0,
                bn.momentum, bn.eps)
        assert float(stats[2, 3]) == (0.0 if dtype == torch.float32 else 1.0)


def test_block_route_rule(monkeypatch):
    """The kernels are taken in train mode on a CUDA device with the batch
    and the features whole there; the CPU, eval mode, a BatchNorm
    `data_group` and a model-axis layout keep the composed ops. A CPU
    model's train step never calls the tail."""
    from jamie_tpu_torch.models import coupled_vae
    blk = coupled_vae._Block(8, 16, 0.0, False).train()
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    assert blk.takes_kernel(cuda) and not blk.takes_kernel(cpu)
    blk.eval()
    assert not blk.takes_kernel(cuda)
    blk.train()
    blk.bn.data_group = object()
    assert not blk.takes_kernel(cuda)
    blk.bn.data_group = None
    blk.dense.tp = object()
    assert not blk.takes_kernel(cuda)

    def tail(*args):
        raise AssertionError('the CPU took the block tail')
    monkeypatch.setattr(coupled_vae, 'block_tail', tail)
    m = CoupledVAE(DIMS, OUT, dropout=0.6).train()
    xs = [torch.randn(B, d) for d in DIMS]
    out = m(xs, torch.rand(B, B), generator=torch.Generator().manual_seed(0))
    sum(t.sum() for t in out[2]).backward()
