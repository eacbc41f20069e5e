"""The 3xTF32 numerics of K3 (`jamie_tpu_torch/csrc/pairwise_sq_euclidean.cu`),
modelled in torch on the CPU.

The kernel splits each float32 operand as v = hi + lo: hi is v with the low
13 mantissa bits cleared (exact in TF32), lo = v - hi rounded to TF32 with
`cvt.rna` (round to nearest, ties away from zero). It sums hi.hi + hi.lo +
lo.hi on the tensor cores with float32 accumulation. A product of two TF32
values (11 significant bits each) is exact in float32, so a float32 matmul
of the split operands models those products; only the summation order
differs from the card.

The model is held to jamie_tpu's Pallas kernel (interpret mode, as
tests/test_torch_kernels.py runs it) and to a float64 reference at 5000
features, at the tolerance the card checks use (1e-5 of the norm scale).
Plain TF32 (hi.hi alone) misses that tolerance at 5000 features, which is
why the kernel takes three products."""

import numpy as np
import pytest
import torch

from jamie_tpu.ops.ab_archive import pairwise_sq_euclidean_pallas

HI_MASK = -8192          # 0xFFFFE000: sign, exponent, 10 mantissa bits


def tf32_hi(t: torch.Tensor) -> torch.Tensor:
    return (t.view(torch.int32) & HI_MASK).view(torch.float32)


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """Round to TF32, nearest with ties away from zero (cvt.rna.tf32.f32):
    adding half a TF32 ulp to the magnitude bits, then truncating."""
    return ((t.view(torch.int32) + 0x1000) & HI_MASK).view(torch.float32)


def split_distances(x: torch.Tensor, y=None, squared: bool = True,
                    products: int = 3) -> torch.Tensor:
    """K3's function with its 3xTF32 dot products (products=1: plain TF32,
    hi.hi only)."""
    assert torch.get_float32_matmul_precision() == 'highest'
    self_dist = y is None
    y = x if y is None else y
    xh, yh = tf32_hi(x), tf32_hi(y)
    dot = xh @ yh.T
    if products == 3:
        dot = tf32_rna(x - xh) @ yh.T + xh @ tf32_rna(y - yh).T + dot
    d = torch.clamp((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
                    - 2.0 * dot, min=0.0)
    if not squared:
        d = torch.sqrt(d)
    if self_dist:
        d.fill_diagonal_(0.0)
    return d


def _norm_scale(x, y):
    return float((x * x).sum(1).max()) + float((y * y).sum(1).max())


def test_split_is_exact_to_two_tf32_terms():
    rng = np.random.RandomState(0)
    x = torch.as_tensor((rng.randn(4096) * 10.0 ** rng.randint(-3, 4, 4096))
                        .astype(np.float32))
    hi = tf32_hi(x)
    lo = tf32_rna(x - hi)
    for t in (hi, lo):   # both are TF32: the low 13 bits are clear
        assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x - hi).abs() <= 2.0 ** -10 * x.abs()).all())
    # what the split drops is below 2^-21 of |x|
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


def test_tf32_rna_rounds_ties_away_from_zero():
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    below = torch.tensor([1.0 + 2.0 ** -11 - 2.0 ** -23])
    assert tf32_rna(below).tolist() == [1.0]


@pytest.mark.parametrize('squared', [True, False])
def test_split_model_matches_pallas_cross(squared):
    rng = np.random.RandomState(1)
    x = rng.randn(70, 33).astype(np.float32)
    y = rng.randn(50, 33).astype(np.float32)
    ref = np.asarray(pairwise_sq_euclidean_pallas(x, y, tile_m=32, tile_n=128,
                                                  tile_k=32))
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    d = split_distances(xt, yt, squared=squared).numpy()
    np.testing.assert_allclose(d if squared else d ** 2, ref,
                               atol=1e-5 * _norm_scale(xt, yt))


def test_split_model_matches_pallas_self():
    rng = np.random.RandomState(2)
    x = rng.randn(40, 10).astype(np.float32)
    ref = np.asarray(pairwise_sq_euclidean_pallas(x, tile_m=32, tile_n=128,
                                                  tile_k=32))
    xt = torch.as_tensor(x)
    tol = 1e-5 * _norm_scale(xt, xt)
    for squared in (True, False):
        d = split_distances(xt, squared=squared).numpy()
        assert (np.diag(d) == 0).all()
        np.testing.assert_allclose(d, d.T, atol=tol)
        np.testing.assert_allclose(d if squared else d ** 2, ref, atol=tol)


@pytest.mark.parametrize('self_dist', [True, False])
def test_three_products_hold_5000_features_and_one_does_not(self_dist):
    """Nonnegative inputs, as the fit's RNA (ReLU) and ATAC (binary) are:
    every product has one sign, so TF32's truncation of hi adds up over the
    features instead of cancelling."""
    rng = np.random.RandomState(3)
    x = rng.rand(64, 5000).astype(np.float32)
    y = x if self_dist else rng.rand(64, 5000).astype(np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    ref = np.maximum((x64 * x64).sum(1)[:, None] + (y64 * y64).sum(1)[None]
                     - 2.0 * x64 @ y64.T, 0.0)
    if self_dist:
        np.fill_diagonal(ref, 0.0)
    xt = torch.as_tensor(x)
    yt = None if self_dist else torch.as_tensor(y)
    tol = 1e-5 * _norm_scale(xt, torch.as_tensor(y))
    err3 = np.abs(split_distances(xt, yt).numpy() - ref).max()
    err1 = np.abs(split_distances(xt, yt, products=1).numpy() - ref).max()
    assert err3 <= tol
    assert err1 > tol
