"""jamie_tpu_torch.solvers.prime_dual against jamie_tpu's dense solver on
the CPU. The reference runs its Pallas tail (use_pallas=True, interpret
mode), the function the port's K1 computes."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from jamie_tpu.solvers.prime_dual import prime_dual as jax_prime_dual
from jamie_tpu_torch.solvers.prime_dual import prime_dual


def _kernels(m, n, seed=3):
    rng = np.random.RandomState(seed)
    z = rng.randn(max(m, n), 4)
    xa = z[:m] @ rng.randn(4, 6) + 0.1 * rng.randn(m, 6)
    xb = z[:n] @ rng.randn(4, 5) + 0.1 * rng.randn(n, 5)
    sq = lambda x: ((x[:, None] - x[None]) ** 2).sum(-1).astype(np.float32)
    return sq(xa), sq(xb)


def _both(Kx, Ky, **kw):
    ref = np.asarray(jax_prime_dual(Kx, Ky, dx=6, dy=5, use_pallas=True, **kw))
    ours = prime_dual(Kx, Ky, dx=6, dy=5, device='cpu', **kw)
    assert ours.dtype == torch.float32
    return ours.numpy(), ref


@pytest.mark.parametrize('mn', [(20, 20), (64, 64), (30, 24)])
def test_highest_precision_matches(mn):
    Kx, Ky = _kernels(*mn)
    ours, ref = _both(Kx, Ky, epoch_pd=50, verbose=False,
                      precision='highest')
    assert ours.shape == mn
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)


def test_default_precision_matches():
    """bf16 operands, f32 result, in both: the products are the same and
    only the f32 summation order differs, so F agrees to 1e-4 of its max
    over 50 iterations."""
    Kx, Ky = _kernels(40, 40)
    ours, ref = _both(Kx, Ky, epoch_pd=50, verbose=False, precision='default')
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * ref.max())


def test_bf16_state_matches():
    """M1, FKy, KxFKy and K stored in bf16: a summation-order difference
    that crosses a bf16 rounding boundary moves a stored value by one bf16
    ulp (2^-8 relative), so F is held at 1e-3 of its max over 50
    iterations."""
    Kx, Ky = _kernels(40, 40)
    ours, ref = _both(Kx, Ky, epoch_pd=50, verbose=False, precision='default',
                      state_dtype='bfloat16')
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3 * ref.max())


def test_printed_lines_agree():
    Kx, Ky = _kernels(32, 32)
    outs = []
    for fn, kw in ((jax_prime_dual, {'use_pallas': True}),
                   (prime_dual, {'device': 'cpu'})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(Kx, Ky, dx=6, dy=5, epoch_pd=40, log_pd=10,
               precision='highest', **kw)
        outs.append(buf.getvalue().splitlines())
    pattern = re.compile(r'^epoch:\[\d+/40\] err:\d+\.\d{4} alpha:\d+\.\d{4}$')
    assert len(outs[0]) == len(outs[1]) == 4
    assert all(pattern.match(line) for line in outs[1])
    assert outs[0] == outs[1]


def test_one_by_one_escape():
    with pytest.warns(UserWarning, match='1x1'):
        F = prime_dual(np.zeros((1, 1)), np.zeros((1, 1)), 1, 1,
                       device='cpu')
    assert F.shape == (1, 1) and float(F) == 1.0


@pytest.mark.parametrize('kw', [{'state_dtype': 'float16'},
                                {'precision': 'fastest'}])
def test_invalid_arguments_raise(kw):
    Kx, Ky = _kernels(8, 8)
    with pytest.raises(ValueError):
        prime_dual(Kx, Ky, 1, 1, epoch_pd=1, device='cpu', **kw)


def _random_carry(m, n, bf16_state, seed=7):
    """A nonzero solver state, the same values for both packages: F, S, Mu,
    Lambda, M1, M2, a, FKy, KxFKy (M1, FKy, KxFKy bf16-representable when
    the state is bf16)."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    big = lambda a: (torch.as_tensor(f32(a)).bfloat16().float().numpy()
                     if bf16_state else f32(a))
    F = f32(rng.rand(m, n) * 0.05)
    return [F, f32(rng.rand(n, 1) * 0.1), f32(rng.randn(m, 1) * 0.1),
            f32(rng.randn(n, 1) * 0.1), big(rng.randn(m, n) * 0.01),
            f32(rng.rand(m, n) * 1e-3), f32(0.9), big(rng.rand(m, n)),
            big(rng.rand(m, n))]


@pytest.mark.parametrize('precision,state_dtype,use_pallas,tol', [
    ('highest', 'float32', False, 1e-5),
    ('highest', 'float32', True, 1e-5),
    ('default', 'float32', False, 1e-5),
    ('default', 'bfloat16', False, 2 ** -7),
])
def test_step_matches_run_chunk(precision, state_dtype, use_pallas, tol):
    """The port's shared step (`_iteration`, the function the card
    captures) run 7 times from step 3 with delay 6 against jamie_tpu's
    `_run_chunk` over the same 7 iterations from the same nonzero state:
    the device counter's bias corrections and the delay gate switching
    inside the chunk. Held per array at `tol` of its largest entry: f32
    summation order (and torch.pow against jnp.power in the bias
    corrections, an ulp at most) for f32 state; a bf16 store may land one
    bf16 ulp (2^-8 relative) away, so 2^-7 for bf16 state."""
    import jax.numpy as jnp
    from jamie_tpu.solvers.prime_dual import _run_chunk
    pdm = __import__('importlib').import_module(
        'jamie_tpu_torch.solvers.prime_dual')
    Kx, Ky = _kernels(28, 20)
    bf16_state = state_dtype == 'bfloat16'
    carry = _random_carry(28, 20, bf16_state)
    kdt = jnp.bfloat16 if (bf16_state and precision == 'default') \
        else jnp.float32
    N = 28.0
    jx, jy = jnp.asarray(Kx / N).astype(kdt), jnp.asarray(Ky / N).astype(kdt)
    tr = jnp.sum(jnp.asarray(Kx / N) * jnp.asarray(Kx / N).T)
    jcarry = tuple(jnp.asarray(c).astype(jnp.bfloat16)
                   if bf16_state and j in (4, 7, 8) else jnp.asarray(c)
                   for j, c in enumerate(carry))
    ref = _run_chunk(jcarry, jnp.asarray(3, jnp.int32), jx, jy, tr, 7, 10.0,
                     1e-3, 6, precision, use_pallas, None, 0, state_dtype)

    bf16_mm = pdm._BF16_PRECISIONS[precision]
    tKx, tKy, ttr, st, _ = pdm.init_state(Kx, Ky, 6, 5, state_dtype,
                                          bf16_mm, torch.device('cpu'))
    names = ('F', 'S', 'Mu', 'Lambda', 'M1', 'M2', 'a', 'FKy', 'KxFKy')
    for name, c in zip(names, carry):
        st[name].copy_(torch.as_tensor(c))
    st['colsum'].copy_(st['F'].sum(0, keepdim=True))
    st['i'].fill_(3)
    step = pdm._iteration(tKx, tKy, ttr, st, pdm._matmul(bf16_mm), 10.0,
                          1e-3, 6, lambda t: t, lambda t: t, None)
    for _ in range(7):
        step()
    assert int(st['i']) == 10
    for name, r in zip(names, ref):
        r = np.asarray(r, np.float32)
        ours = st[name].float().numpy()
        np.testing.assert_allclose(ours, r.reshape(ours.shape), rtol=0,
                                   atol=tol * float(np.abs(r).max()),
                                   err_msg=name)


def test_printed_lines_agree_with_delay_and_a_partial_chunk():
    """epoch_pd 45 with log_pd 10 (the last chunk is 5 iterations and
    prints nothing) and delay 12 (the gate flips inside the second chunk):
    the printed lines are jamie_tpu's, character for character, and F
    agrees at test_highest_precision_matches's tolerance."""
    Kx, Ky = _kernels(32, 28)
    outs, Fs = [], []
    for fn, kw in ((jax_prime_dual, {'use_pallas': False}),
                   (prime_dual, {'device': 'cpu'})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            Fs.append(np.asarray(fn(Kx, Ky, dx=6, dy=5, epoch_pd=45,
                                    log_pd=10, delay=12,
                                    precision='highest', **kw)))
        outs.append(buf.getvalue().splitlines())
    assert [line.split(']')[0] for line in outs[1]] == [
        f'epoch:[{i}/45' for i in (10, 20, 30, 40)]
    assert outs[0] == outs[1]
    np.testing.assert_allclose(Fs[1], Fs[0], rtol=1e-4, atol=1e-6)
