"""The port's subpackages export what jamie_tpu's do: every name in
jamie_tpu.{core,ops,train}.__all__ imports from the port's subpackage of
the same name, and the ported helpers behind them (make_sampler,
resolve_dtype, ops.pairwise_sq_euclidean) agree with jamie_tpu's."""

import importlib

import numpy as np
import pytest
import torch

SUBPACKAGES = ('core', 'ops', 'train')
# jamie_tpu's TrainState holds an optax state tree; the port's FitState
# holds the same fit with Adam's state as flat mu, nu and count fields,
# so it is exported under its own name
EXCEPTIONS = {('train', 'TrainState'): 'FitState'}


def _jax_names():
    out = []
    for sub in SUBPACKAGES:
        mod = importlib.import_module(f'jamie_tpu.{sub}')
        out += [(sub, name) for name in mod.__all__]
    return out


@pytest.mark.parametrize('sub,name', _jax_names(),
                         ids=lambda v: str(v))
def test_name_imports_from_the_port(sub, name):
    mod = importlib.import_module(f'jamie_tpu_torch.{sub}')
    name = EXCEPTIONS.get((sub, name), name)
    assert name in mod.__all__
    assert getattr(mod, name) is not None


def test_trainstate_exception_has_the_fit_fields():
    from jamie_tpu.train import TrainState
    from jamie_tpu_torch.train import FitState
    jax_fields = set(TrainState.__dataclass_fields__)
    ours = set(FitState.__dataclass_fields__)
    assert jax_fields - ours == {'opt_state'}
    assert ours - jax_fields == {'mu', 'nu', 'count'}


@pytest.mark.parametrize('name', ['float32', 'bfloat16', 'float16',
                                  'float64'])
def test_resolve_dtype(name):
    from jamie_tpu.core import resolve_dtype as jax_resolve
    from jamie_tpu_torch.core import resolve_dtype
    got = resolve_dtype(name)
    assert got == getattr(torch, name)
    assert str(got).split('.')[-1] == np.dtype(jax_resolve(name)).name
    assert resolve_dtype(got) is got


def test_pairwise_sq_euclidean_matches():
    from jamie_tpu.ops import pairwise_sq_euclidean as jax_sq
    from jamie_tpu_torch.ops import pairwise_sq_euclidean
    rng = np.random.RandomState(0)
    x = rng.randn(40, 7).astype(np.float32)
    y = rng.randn(30, 7).astype(np.float32)
    for args in ((x,), (x, y)):
        want = np.asarray(jax_sq(*args))
        got = pairwise_sq_euclidean(*args, device='cpu').numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('method', ['diag', 'zeros', 'hybrid'])
def test_make_sampler_draws(method):
    """One step's batch: the regime's structure, as jamie_tpu's sampler
    (the draws come from a torch.Generator, so the streams differ)."""
    import jax
    from jamie_tpu.train import make_sampler as jax_make
    from jamie_tpu_torch.train import make_sampler
    rows, B = (50, 60), 16
    pairs = np.stack([np.arange(10), np.arange(10) + 5], 1)
    kw = {'corr_pairs': pairs} if method == 'hybrid' else {}
    sample = make_sampler(method, rows, B, **kw)
    jax_sample = jax_make(method, rows, B, **kw)
    gen = torch.Generator().manual_seed(0)
    for draw in range(3):
        i0, i1 = sample(gen)
        j0, j1 = (np.asarray(a) for a in jax_sample(jax.random.PRNGKey(draw)))
        assert i0.shape == i1.shape == j0.shape == (B,)
        assert i0.dtype == torch.int64
        assert int(i0.max()) < rows[0] and int(i1.max()) < rows[1]
        if method == 'diag':
            assert torch.equal(i0, i1) and np.array_equal(j0, j1)
            assert len(set(i0.tolist())) == B   # without replacement
        if method == 'hybrid':
            paired = np.isin(i0.numpy(), pairs[:, 0]) & (
                i1.numpy() == i0.numpy() + 5)
            assert paired.any()
    if method == 'hybrid':
        other = np.stack([np.arange(3), np.arange(3)], 1)
        i0, i1 = sample(gen, pairs=other)
        took = np.isin(i0.numpy(), other[:, 0]) & (i0 == i1).numpy()
        assert took.mean() > 0.3


def test_make_sampler_with_replacement_and_errors():
    from jamie_tpu_torch.train import make_sampler
    i0, i1 = make_sampler('zeros', (5, 7), 12)(torch.Generator().manual_seed(1))
    assert i0.shape == (12,) and int(i0.max()) < 5 and int(i1.max()) < 7
    with pytest.raises(ValueError, match='matched pairs'):
        make_sampler('hybrid', (5, 5), 4)
    with pytest.raises(ValueError, match='does not exist'):
        make_sampler('nope', (5, 5), 4)
