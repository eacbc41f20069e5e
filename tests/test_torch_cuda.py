"""Kernels against their plain PyTorch versions on a CUDA card.

Marked `cuda`; each test skips without a card. This file imports neither
jax nor jamie_tpu, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from jamie_tpu_torch import ops
from jamie_tpu_torch.core import dtypes
from jamie_tpu_torch.ops import pairwise, pd_update

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _rand(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(*shape, device=dev, generator=g)


@pytest.mark.parametrize('m1_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(24, 136), (1047, 1047), (1000, 1037)])
def test_pd_grad_update_kernel_matches_plain(cuda, shape, m1_dtype):
    m, n = shape
    F, M2, mm4 = (_rand(cuda, m, n, seed=s) for s in (1, 2, 3))
    M1 = (_rand(cuda, m, n, seed=4) - 0.5).to(m1_dtype)
    kx = _rand(cuda, m, n, seed=5).to(m1_dtype)
    Mu, Lam, S = _rand(cuda, m, 1, seed=6), _rand(cuda, n, 1, seed=7), \
        _rand(cuda, n, 1, seed=8)
    args = (F, M1, M2, mm4, kx, Mu, Lam, S, F.sum(1, keepdim=True),
            F.sum(0, keepdim=True), torch.tensor(0.7, device=cuda), 7, 1e-3,
            10.0)
    ops.reset_launch_counts()
    got = pd_update.fused_pd_grad_update(*args)
    want = pd_update.fused_pd_grad_update_plain(*args)
    torch.cuda.synchronize()
    assert pd_update.fused_pd_grad_update.launches == 1
    assert got[1].dtype == m1_dtype
    # f32 rounding order (rtol 1e-5); a bf16 M1' within one bf16 ulp
    for g, w in zip(got, want):
        rtol = 8e-3 if w.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=1e-6 * float(w.float().abs().max()))


def test_pd_update_kernel_matches_plain(cuda):
    F, M2, grad = (_rand(cuda, 1047, 1047, seed=s) for s in (1, 2, 3))
    M1 = _rand(cuda, 1047, 1047, seed=4) - 0.5
    got = pd_update.fused_pd_update(F, M1, M2, grad, 7, 1e-3)
    want = pd_update.fused_pd_update_plain(F, M1, M2, grad, 7, 1e-3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize('squared', [True, False])
@pytest.mark.parametrize('self_dist', [True, False])
@pytest.mark.parametrize('mnf', [(70, 50, 33), (1000, 1037, 333),
                                 (1047, 1047, 5000)])
def test_pairwise_kernel_matches_plain(cuda, mnf, self_dist, squared):
    m, n, f = mnf
    x = torch.randn(m, f, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    y = None if self_dist else torch.randn(n, f, device=cuda)
    got = pairwise.pairwise_euclidean(x, y, squared=squared)
    want = pairwise.pairwise_euclidean_plain(x, y, squared=squared)
    # Gram cancellation in float32: held on the squares, to 1e-5 of the
    # norm scale
    scale = float((x * x).sum(1).max()) * 2
    g2, w2 = (got, want) if squared else (got * got, want * want)
    assert float((g2 - w2).abs().max()) <= 1e-5 * scale
    if self_dist:
        assert bool((torch.diagonal(got) == 0).all())


@pytest.mark.parametrize('mkn', [(1047, 1047, 1047), (1047, 512, 1047),
                                 (512, 1047, 32)])
def test_bf16_matmul_matches_rounded_f32(cuda, mkn):
    """bf16_matmul's card route (torch.mm with an f32 result, where the
    build has it) against the rounded-f32 route the CPU parity tests hold
    to jamie_tpu: each bf16 x bf16 product is exact in f32, so only the
    summation order differs, within 1e-5 of sum |a||b|. A bf16-rounded
    result would miss this by ~2^-9 relative."""
    m, k, n = mkn
    a = torch.randn(m, k, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(1))
    b = torch.randn(k, n, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(2))
    got = dtypes.bf16_matmul(a, b)
    ar, br = a.bfloat16().float(), b.bfloat16().float()
    assert not torch.backends.cuda.matmul.allow_tf32
    want = ar @ br
    assert got.dtype == torch.float32
    scale = ar.abs() @ br.abs()
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_kernel_wrappers_refuse_bad_cuda_inputs(cuda):
    x = torch.zeros((8, 4), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        pairwise.pairwise_euclidean(x)
    with pytest.raises(ValueError):
        pairwise.pairwise_euclidean(torch.zeros((8, 4), device=cuda).T)
