"""The port exports what jamie_tpu does: every name in the `__all__` of
every jamie_tpu module that has one imports from the port's module of the
same name, and the ported helpers behind them (make_sampler,
resolve_dtype, ops.pairwise_sq_euclidean) agree with jamie_tpu's. The
keywords of jamie_tpu's signatures that the port had lacked are each
accepted and ignored, or honoured, as their docstrings say."""

import importlib
import inspect
import pathlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _modules_with_all():
    """'' for the package, else the dotted name under it, of every
    jamie_tpu module whose source binds __all__."""
    out = []
    for path in sorted((ROOT / 'jamie_tpu').rglob('*.py')):
        if '\n__all__' not in '\n' + path.read_text():
            continue
        parts = path.relative_to(ROOT / 'jamie_tpu').with_suffix('').parts
        out.append('.'.join(parts[:-1] if parts[-1] == '__init__'
                            else parts))
    return out


SUBPACKAGES = tuple(_modules_with_all())
# jamie_tpu's TrainState holds an optax state tree; the port's FitState
# holds the same fit with Adam's state as flat mu, nu and count fields,
# so it is exported under its own name
EXCEPTIONS = {('train', 'TrainState'): 'FitState'}


def _module(package, sub):
    return importlib.import_module(package + (f'.{sub}' if sub else ''))


def _jax_names():
    out = []
    for sub in SUBPACKAGES:
        out += [(sub, name) for name in _module('jamie_tpu', sub).__all__]
    return out


def test_every_module_with_all_is_checked():
    assert set(SUBPACKAGES) == {'', 'core', 'evaluation', 'figures',
                                'models', 'normalize', 'ops', 'solvers',
                                'train'}


@pytest.mark.parametrize('sub,name', _jax_names(),
                         ids=lambda v: str(v))
def test_name_imports_from_the_port(sub, name):
    mod = _module('jamie_tpu_torch', sub)
    name = EXCEPTIONS.get((sub, name), name)
    assert name in mod.__all__
    assert getattr(mod, name) is not None


def test_solvers_prime_dual_is_the_function_as_in_jamie_tpu():
    import jamie_tpu.solvers as js
    import jamie_tpu_torch.solvers as ts
    assert callable(js.prime_dual) and callable(ts.prime_dual)
    assert ts.prime_dual.__module__ == 'jamie_tpu_torch.solvers.prime_dual'
    pairs = np.array([[0.9, 0.1, 0.0], [0.0, 0.2, 0.8], [0.1, 0.7, 0.2]])
    np.testing.assert_array_equal(np.asarray(ts.hungarian_pairs(pairs)),
                                  np.asarray(js.hungarian_pairs(pairs)))


def test_is_lowrank():
    from jamie_tpu.ops.lowrank import LowRankF as JLowRankF
    from jamie_tpu.ops.lowrank import is_lowrank as jax_is_lowrank
    from jamie_tpu_torch.ops.lowrank import (LowRankF, SparseLandmarkF,
                                             from_fields, is_lowrank)
    rng = np.random.RandomState(0)
    u, v = rng.rand(6, 2).astype(np.float32), rng.rand(5, 2).astype(np.float32)
    ours = LowRankF(u, v, device='cpu')
    assert is_lowrank(ours) and jax_is_lowrank(JLowRankF(u, v))
    sparse = from_fields(type('F', (), dict(
        ix=np.zeros((6, 1), np.int32), wx=np.ones((6, 1), np.float32),
        iy=np.zeros((5, 1), np.int32), wy=np.ones((5, 1), np.float32),
        f_l=np.ones((1, 1), np.float32)))(), device='cpu')
    assert isinstance(sparse, SparseLandmarkF) and is_lowrank(sparse)
    for other in (np.ones((6, 5)), 'identity', None):
        assert not is_lowrank(other) and not jax_is_lowrank(other)


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


# ------------------------------------------------------------ keywords
# Each keyword of a jamie_tpu signature that the port lacked: accepted and
# ignored (use_pallas, block, limit_bytes) or honoured (dtype,
# opt_state_arrays, train, devices).

def _kw_use_pallas(monkeypatch, tmp_path):
    """Every value leaves the solve on the K1 wrapper (the kernel on the
    card, its plain version on the CPU) and gives the same F."""
    pdm = importlib.import_module('jamie_tpu_torch.solvers.prime_dual')
    calls = []
    real = pdm.fused_pd_grad_update
    monkeypatch.setattr(pdm, 'fused_pd_grad_update',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = np.random.RandomState(0).rand(12, 5).astype(np.float32)
    K = ((x[:, None] - x[None]) ** 2).sum(-1)
    kw = dict(epoch_pd=6, verbose=False, device='cpu')
    want = pdm.prime_dual(K, K[::-1, ::-1].copy(), 5, 5, **kw).numpy()
    for flag in (None, True, False):
        got = pdm.prime_dual(K, K[::-1, ::-1].copy(), 5, 5, use_pallas=flag,
                             **kw).numpy()
        np.testing.assert_array_equal(got, want)
    assert len(calls) == 4 * 6


def _kw_block(monkeypatch, tmp_path):
    from jamie_tpu.ops import distances as jd
    from jamie_tpu_torch.ops import distances as td
    rng = np.random.RandomState(1)
    x = rng.randn(30, 6).astype(np.float32)
    y = rng.randn(20, 6).astype(np.float32)
    for block in (4, 4096):
        ref = np.asarray(jd.pairwise_sq_euclidean(x, y, block))
        got = td.pairwise_sq_euclidean(x, y, block, device='cpu').numpy()
        np.testing.assert_array_equal(
            got, td.pairwise_sq_euclidean(x, y, device='cpu').numpy())
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        ref = np.asarray(jd.pairwise_distance(x, 'euclidean', block))
        got = td.pairwise_distance(x, 'euclidean', block,
                                   device='cpu').numpy()
        np.testing.assert_array_equal(
            got, td.pairwise_distance(x, device='cpu').numpy())
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def _kw_limit_bytes(monkeypatch, tmp_path):
    from jamie_tpu_torch.core import residency as R
    x = np.random.RandomState(2).randn(40, 9).astype(np.float32)
    for src in (x, sp.csr_matrix(np.maximum(x, 0))):
        want = R.ChunkUploader(src, device='cpu').rows(3, 30)
        got = R.ChunkUploader(src, device='cpu', limit_bytes=64).rows(3, 30)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _kw_dtype(monkeypatch, tmp_path):
    from jamie_tpu.core import hostmat as jh
    from jamie_tpu_torch.core import hostmat as th
    x = np.random.RandomState(3).rand(7, 5)
    for src in (x, sp.csr_matrix(x), sp.csc_matrix(x)):
        for fn in ('dense_rows', 'dense_cols'):
            for kw in ({}, {'dtype': np.float64}, {'dtype': None}):
                got = getattr(th, fn)(src, 1, 4, **kw)
                ref = getattr(jh, fn)(src, 1, 4, **kw)
                assert got.dtype == ref.dtype
                assert got.flags['C_CONTIGUOUS']
                np.testing.assert_array_equal(got, ref)
    assert th.dense_rows(x, 0, 2, dtype=np.float64).dtype == np.float64


def _kw_opt_state_arrays(monkeypatch, tmp_path):
    """The extra arrays are written beside the model's, as jamie_tpu
    writes them; both packages' load_checkpoint read either file."""
    from jamie_tpu import persistence as jp
    from jamie_tpu_torch import persistence as tp
    rng = np.random.RandomState(4)
    params = {'enc0': {'kernel': rng.rand(3, 2).astype(np.float32)}}
    stats = {'bn0': {'mean': rng.rand(2).astype(np.float32)}}
    opt = {'opt/mu': rng.rand(6).astype(np.float32),
           'opt/count': np.array(7, np.int32)}
    header = {'num_modalities': 2}
    files = {}
    for name, mod in (('jax', jp), ('port', tp)):
        files[name] = str(tmp_path / f'{name}.npz')
        mod.save_checkpoint(files[name], params, stats, (), header,
                            opt_state_arrays=opt)
    with np.load(files['jax']) as a, np.load(files['port']) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in opt:
            np.testing.assert_array_equal(b[key], opt[key])
            np.testing.assert_array_equal(b[key], a[key])
    for path in files.values():
        for load in (jp.load_checkpoint, tp.load_checkpoint):
            p, s, pres, h = load(path)
            np.testing.assert_array_equal(p['enc0']['kernel'],
                                          params['enc0']['kernel'])
            np.testing.assert_array_equal(s['bn0']['mean'],
                                          stats['bn0']['mean'])
            assert pres == () and h == header


def _kw_train(monkeypatch, tmp_path):
    """train=True runs BatchNorm on the batch (held against jamie_tpu's
    train=True at dropout 0) and dropout; train=False the running stats;
    the module's mode, and each submodule's, are left as they were."""
    import jax
    import jax.numpy as jnp
    from jamie_tpu.models.coupled_vae import CoupledVAE as FlaxVAE
    from jamie_tpu_torch.models.convert import load_flax_variables
    from jamie_tpu_torch.models.coupled_vae import CoupledVAE
    dims, out = (12, 9), 5
    rng = np.random.RandomState(5)
    xs = [rng.randn(16, d).astype(np.float32) for d in dims]
    fm = FlaxVAE(input_dim=dims, output_dim=out, dropout=0.0)
    variables = jax.tree.map(np.asarray, fm.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1),
         'reparam': jax.random.PRNGKey(2)},
        [jnp.asarray(x) for x in xs], jnp.eye(16), train=True))
    tm = CoupledVAE(dims, out, dropout=0.0)

    def flax(method, *args, train):
        out_, _ = fm.apply(variables, *args, train=train, method=method,
                           rngs={'dropout': jax.random.PRNGKey(3),
                                 'reparam': jax.random.PRNGKey(4)},
                           mutable=['batch_stats'])
        return out_

    tol = dict(rtol=1e-5, atol=1e-5)
    for train in (True, False):
        for start in ('eval', 'train'):
            # a train=True call moved the running statistics: start afresh
            load_flax_variables(tm, variables['params'],
                                variables['batch_stats'])
            getattr(tm, start)()
            tm.layers['enc0_b0'].bn.train(start == 'eval')   # a mixed mode
            modes = [m.training for m in tm.modules()]
            with torch.no_grad():
                h = tm.encode_one(torch.as_tensor(xs[0]), 0, train)
                _, mu, logvar = tm.refactor_one(h, 0, train=train)
                x_hat = tm.decode_one(mu, 1, train=train)
                emb = tm.embed_one(torch.as_tensor(xs[1]), 1, train)
                imp = tm.impute(torch.as_tensor(xs[0]), 0, 1, train)
            assert [m.training for m in tm.modules()] == modes
            ref_h = flax(FlaxVAE.encode_one, jnp.asarray(xs[0]), 0,
                         train=train)
            np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **tol)
            _, ref_mu, ref_lv = flax(FlaxVAE.refactor_one, ref_h, 0,
                                     train=train)
            np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), **tol)
            np.testing.assert_allclose(logvar.numpy(), np.asarray(ref_lv),
                                       **tol)
            ref = flax(FlaxVAE.decode_one, ref_mu, 1, train=train)
            np.testing.assert_allclose(x_hat.numpy(), np.asarray(ref), **tol)
            ref = flax(FlaxVAE.embed_one, jnp.asarray(xs[1]), 1, train=train)
            np.testing.assert_allclose(emb.numpy(), np.asarray(ref), **tol)
            assert imp.shape == (16, dims[1])
            if not train:
                ref = flax(FlaxVAE.impute, jnp.asarray(xs[0]), 0, 1,
                           train=False)
                np.testing.assert_allclose(imp.numpy(), np.asarray(ref),
                                           **tol)
    # with dropout, train=True draws masks and train=False does not
    tm = CoupledVAE(dims, out, dropout=0.5).eval()
    x = torch.as_tensor(xs[0])
    with torch.no_grad():
        a, b = tm.encode_one(x, 0), tm.encode_one(x, 0, train=False)
        c = tm.encode_one(x, 0, train=True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not any(m.training for m in tm.modules())


def _kw_devices(monkeypatch, tmp_path):
    """devices= names the ranks' devices; a list the group cannot fill
    raises jamie_tpu's ValueError for a shape it cannot fill."""
    import jax
    from jamie_tpu.core.mesh import create_mesh as jax_create_mesh
    from jamie_tpu_torch.core import mesh as cm
    cpu = jax.devices('cpu')[0]
    with pytest.raises(ValueError, match=r'mesh shape \(2,\) needs 2 '
                                         r'devices, have 1'):
        jax_create_mesh((2,), devices=[cpu])
    with pytest.raises(ValueError, match=r'mesh shape \(2,\) needs 2 '
                                         r'devices, have 1'):
        cm.create_mesh((2,), devices=[torch.device('cpu')])
    with pytest.raises(ValueError, match=r'mesh shape \(2,\) needs 2 '
                                         r'devices, have 1'):
        cm.create_mesh(devices=['cpu', 'cpu'])
    with pytest.raises(ValueError, match='needs 2 devices'):
        cm.create_mesh(devices=['cpu', 'meta'])
    with pytest.raises(ValueError, match='needs 1 devices'):
        cm.create_mesh(devices=['cpu'], device_type='cuda')
    assert not torch.distributed.is_initialized()
    try:
        mesh = cm.create_mesh(devices=[torch.device('cpu')])
        assert mesh.device_type == 'cpu' and tuple(mesh.shape) == (1,)
        assert torch.distributed.get_world_size() == 1
    finally:
        cm.destroy_group()
    assert len(jax_create_mesh(devices=[cpu]).devices.ravel()) == 1


KEYWORDS = {
    'prime_dual(use_pallas=)': _kw_use_pallas,
    'pairwise_distance/pairwise_sq_euclidean(block=)': _kw_block,
    'ChunkUploader(limit_bytes=)': _kw_limit_bytes,
    'dense_rows/dense_cols(dtype=)': _kw_dtype,
    'save_checkpoint(opt_state_arrays=)': _kw_opt_state_arrays,
    'CoupledVAE.*_one/impute(train=)': _kw_train,
    'create_mesh(devices=)': _kw_devices,
}


@pytest.mark.parametrize('keyword', sorted(KEYWORDS))
def test_jamie_tpu_keyword(monkeypatch, tmp_path, keyword):
    KEYWORDS[keyword](monkeypatch, tmp_path)


def test_keywords_cover_the_signature_diff():
    """Each keyword in these jamie_tpu signatures is in the port's."""
    pairs = [('solvers.prime_dual', 'prime_dual'),
             ('ops.distances', 'pairwise_distance'),
             ('ops.distances', 'pairwise_sq_euclidean'),
             ('core.residency', 'ChunkUploader'),
             ('core.hostmat', 'dense_rows'), ('core.hostmat', 'dense_cols'),
             ('persistence', 'save_checkpoint'), ('core.mesh', 'create_mesh')]
    pairs += [('models.coupled_vae', f'CoupledVAE.{m}') for m in (
        'encode_one', 'refactor_one', 'decode_one', 'embed_one', 'impute')]
    for mod, name in pairs:
        objs = []
        for package in ('jamie_tpu', 'jamie_tpu_torch'):
            obj = importlib.import_module(f'{package}.{mod}')
            for part in name.split('.'):
                obj = getattr(obj, part)
            objs.append(set(inspect.signature(obj).parameters))
        assert objs[0] <= objs[1], (mod, name, objs[0] - objs[1])
