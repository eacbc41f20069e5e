"""jamie_tpu_torch.models.{baselines,simple} against jamie_tpu's flax
modules on the CPU, with the flax variables carried across by
models/convert.py.

Tolerances: the eval forward of every module within 1e-6 of its largest
output (float32, same weights); `SimpleCoupledAE`'s train forward and its
BatchNorm running stats within 1e-6; a round trip through
`to_flax_variables` is exact. `predict_nn`'s step: with the batch indices
injected and p = 0, three AdamW steps of the port's `train_step` against
the same steps rebuilt in the test from jamie_tpu's `SimpleCommonDualModel`
and `optax.adamw(1e-3)`: losses within 1e-6 relative, parameters within
1e-6 absolute.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from jamie_tpu.models import baselines as ref
from jamie_tpu.models.simple import SimpleCoupledAE as FlaxSimpleAE
from jamie_tpu_torch.models import baselines as port
from jamie_tpu_torch.models.convert import (load_flax_variables,
                                            to_flax_variables)
from jamie_tpu_torch.models.simple import SimpleCoupledAE, SimpleJAMIEModel

F_IN, F_OUT, N = 7, 5, 12


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, F_IN).astype(np.float32),
            rng.randn(N, F_OUT).astype(np.float32))


# (flax module, port module, whether forward takes both modalities)
MODULES = {
    'SimpleModel': (ref.SimpleModel(F_IN, F_OUT),
                    port.SimpleModel(F_IN, F_OUT), False),
    'SingleModel': (ref.SingleModel(F_IN, F_OUT),
                    port.SingleModel(F_IN, F_OUT), False),
    'SimpleDualModel': (ref.SimpleDualModel(F_IN, F_OUT),
                        port.SimpleDualModel(F_IN, F_OUT), True),
    'SimpleCommonDualModel': (ref.SimpleCommonDualModel(F_IN, F_OUT),
                              port.SimpleCommonDualModel(F_IN, F_OUT), True),
    'BABELMini': (ref.BABELMini(F_IN, F_OUT), port.BABELMini(F_IN, F_OUT),
                  True),
}


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else [out])]


@pytest.mark.parametrize('name', sorted(MODULES))
def test_baseline_eval_forward_and_round_trip(name):
    fm, tm, dual = MODULES[name]
    x0, x1 = _data()
    args = (x0, x1) if dual else (x0,)
    key = jax.random.PRNGKey(1)
    params = _np_tree(fm.init({'params': key, 'dropout': key}, *args,
                              train=False)['params'])
    load_flax_variables(tm, params)
    tm.eval()
    with torch.no_grad():
        got = _outputs(tm(*[torch.tensor(a) for a in args]))
    want = _outputs(fm.apply({'params': params}, *args, train=False))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())
    if hasattr(tm, 'last_forward'):
        with torch.no_grad():
            g = tm.last_forward(torch.tensor(x0)).numpy()
        w = np.asarray(fm.apply({'params': params}, x0,
                                method=type(fm).last_forward))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())
    back, stats = to_flax_variables(tm)
    assert stats == {}
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def _simple_ae_pair():
    x0, x1 = _data(2)
    corr = np.random.RandomState(3).rand(N, N).astype(np.float32)
    fm = FlaxSimpleAE((F_IN, F_OUT), 4)
    variables = _np_tree(fm.init(jax.random.PRNGKey(4), [x0, x1], corr))
    # non-trivial running stats, so eval mode reads them
    rng = np.random.RandomState(5)
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda a: (a + 0.3 * rng.rand(*a.shape)).astype(np.float32),
        variables['batch_stats'])
    tm = SimpleCoupledAE((F_IN, F_OUT), 4)
    load_flax_variables(tm, variables['params'], variables['batch_stats'])
    return fm, variables, tm, [x0, x1], corr


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(np.abs(want).max(), 1.0))


def test_simple_coupled_ae_eval_forward_and_round_trip():
    fm, variables, tm, xs, corr = _simple_ae_pair()
    assert SimpleJAMIEModel is SimpleCoupledAE
    tm.eval()
    with torch.no_grad():
        emb, rec = tm([torch.tensor(x) for x in xs], torch.tensor(corr))
    emb_r, rec_r = fm.apply(variables, xs, corr, train=False)
    for g, w in zip(emb + rec, list(emb_r) + list(rec_r)):
        _close(g.numpy(), np.asarray(w))
    params, stats = to_flax_variables(tm)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           (params, stats),
                           (variables['params'], variables['batch_stats']))


def test_simple_coupled_ae_train_forward_updates_stats():
    fm, variables, tm, xs, corr = _simple_ae_pair()
    tm.train()
    with torch.no_grad():
        emb, rec = tm([torch.tensor(x) for x in xs], torch.tensor(corr))
    (emb_r, rec_r), new = fm.apply(variables, xs, corr, train=True,
                                   mutable=['batch_stats'])
    for g, w in zip(emb + rec, list(emb_r) + list(rec_r)):
        _close(g.numpy(), np.asarray(w))
    _, stats = to_flax_variables(tm)
    jax.tree_util.tree_map(lambda g, w: _close(g, np.asarray(w)), stats,
                           _np_tree(new['batch_stats']))


def test_dropout_draws_from_the_generator():
    tm = port.SimpleModel(F_IN, F_OUT, p=0.5)
    x = torch.tensor(_data()[0])
    outs = [tm(x, torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    tm.eval()
    assert torch.equal(tm(x), tm(x))


def test_simple_dual_model_loss_stops_the_bridge_gradient():
    tm = port.SimpleDualModel(F_IN, F_OUT, p=0.0)
    x0, x1 = (torch.tensor(a) for a in _data())
    loss = port.SimpleDualModel.loss(tm(x0, x1), x0, x1)
    grads = torch.autograd.grad(loss, [tm.fc2_1.weight])
    # fc2_1 feeds e2, which enters the tie term only through .detach()
    logits = tm(x0, x1)
    recon = ((logits[1] - x1) ** 2).mean()
    (want,) = torch.autograd.grad(recon, [tm.fc2_1.weight])
    torch.testing.assert_close(grads[0], want)


def test_predict_nn_steps_match_optax_adamw():
    x, y = _data(6)
    batches = [np.random.RandomState(7 + s).choice(N, 8, replace=False)
               for s in range(3)]
    fm = ref.SimpleCommonDualModel(F_IN, F_OUT, p=0.0)
    params = fm.init({'params': jax.random.PRNGKey(8),
                      'dropout': jax.random.PRNGKey(9)}, x[:2], y[:2],
                     train=True)['params']
    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)

    tm = port.SimpleCommonDualModel(F_IN, F_OUT, p=0.0)
    load_flax_variables(tm, _np_tree(params))
    tm.train()
    opt = port.AdamW(tm.parameters())
    for idx in batches:
        xb, yb = x[idx], y[idx]

        def loss_fn(p):
            logits = fm.apply({'params': p}, xb, yb, train=True,
                              rngs={'dropout': jax.random.PRNGKey(0)})
            return ref.SimpleCommonDualModel.loss(logits, xb, yb)

        loss_r, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        loss_p = port.train_step(tm, opt, torch.tensor(xb), torch.tensor(yb))
        assert float(loss_p) == pytest.approx(float(loss_r), rel=1e-6)
        got, _ = to_flax_variables(tm)
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, np.asarray(w),
                                                    rtol=0, atol=1e-6),
            got, params)


def test_predict_nn_runs_and_learns():
    rng = np.random.RandomState(10)
    z = rng.randn(64, 3).astype(np.float32)
    src = z @ rng.randn(3, 9).astype(np.float32)
    tgt = z @ rng.randn(3, 4).astype(np.float32)
    pred = port.predict_nn(src, tgt, epochs=40, batch_size=16, device='cpu')
    assert pred.shape == tgt.shape and np.isfinite(pred).all()
    assert np.mean((pred - tgt) ** 2) < np.mean((tgt - tgt.mean(0)) ** 2)
    val = port.predict_nn(src, tgt, val=src[:5], epochs=1, device='cpu')
    assert val.shape == (5, 4)
    again = port.predict_nn(src, tgt, val=src[:5], epochs=1, device='cpu')
    np.testing.assert_array_equal(val, again)
