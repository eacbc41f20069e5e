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
