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
