"""Every distance mode of jamie_tpu_torch.ops.distances against
jamie_tpu.ops.distances on the CPU: the device metrics in torch, the host
fallbacks through scipy (jamie_tpu calls sklearn, which the card's machine
lacks), spearman and pearson."""

import numpy as np
import pytest
import scipy.sparse
import torch
from scipy.stats import rankdata

from jamie_tpu.config import DISTANCE_MODES
from jamie_tpu.ops import distances as jd
from jamie_tpu_torch.config import DISTANCE_MODES as TORCH_MODES
from jamie_tpu_torch.ops import distances as td


def _np(d):
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def _data(n=30, f=8, seed=0):
    """Nonnegative with ~40% exact zeros, so the boolean metrics see both
    values; haversine takes two columns of (latitude, longitude)."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, f) * (rng.rand(n, f) > 0.4)).astype(np.float32)


def test_both_packages_list_the_same_modes():
    assert TORCH_MODES == DISTANCE_MODES and len(DISTANCE_MODES) == 30


@pytest.mark.parametrize('mode', [m for m in DISTANCE_MODES
                                  if m != 'geodesic'])
def test_metric_matches_reference(mode):
    """Each mode's matrix within 1e-5 of its largest entry: the host
    fallbacks run the same scipy code in float64 (measured 0 apart, 7.5e-8
    for seuclidean); the device metrics are float32 Grams or broadcasts in
    two libraries (measured at most 1.2e-7)."""
    x = _data()
    if mode == 'haversine':
        x = x[:, :2]
    ref = np.asarray(jd.dataset_distance_matrix(x, mode))
    ours = _np(td.dataset_distance_matrix(x, mode, device='cpu'))
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (30, 30)
    scale = float(np.nanmax(np.abs(ref)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * scale)


def test_nan_euclidean_with_missing_values():
    """sklearn's missing-value rescaling, and NaN where two rows share no
    coordinate (row 5 is all NaN)."""
    x = _data(seed=1)
    x[3, 2] = np.nan
    x[5] = np.nan
    ref = np.asarray(jd.pairwise_distance(x, 'nan_euclidean'))
    ours = td.pairwise_distance(x, 'nan_euclidean', device='cpu').numpy()
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('mode', ['haversine', 'no_such_metric'])
def test_metric_errors_match_reference(mode):
    """haversine on more than 2 columns and an unknown name raise
    ValueError in both packages."""
    x = _data()
    with pytest.raises(ValueError):
        jd.pairwise_distance(x, mode)
    with pytest.raises(ValueError):
        td.pairwise_distance(x, mode, device='cpu')


def test_rank_rows_ties_and_nan_match_reference():
    """Average ranks are exact on ties (scipy's rankdata), and NaNs sort
    last and tie with each other, as jamie_tpu ranks them."""
    rng = np.random.RandomState(2)
    x = rng.randint(0, 4, (10, 12)).astype(np.float32)
    ours = td._rank_rows(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(ours, rankdata(x, axis=1))
    x[2, [3, 5]] = np.nan
    x[4, 1] = np.inf
    np.testing.assert_array_equal(td._rank_rows(torch.as_tensor(x)).numpy(),
                                  np.asarray(jd._rank_rows(x)))


@pytest.mark.parametrize('mode', ['spearman', 'pearson'])
def test_rank_and_pearson_edge_cases(mode):
    """One row gives the (1, 1) zero matrix; a NaN entry gives what
    jamie_tpu gives (finite for spearman, whose ranks are finite; NaN rows
    for pearson)."""
    x = _data(seed=3)
    one = td.dataset_distance_matrix(x[:1], mode, device='cpu')
    np.testing.assert_array_equal(_np(one), np.zeros((1, 1), np.float32))
    x[1, 2] = np.nan
    ref = np.asarray(jd.dataset_distance_matrix(x, mode))
    ours = _np(td.dataset_distance_matrix(x, mode, device='cpu'))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize('mode', ['cosine', 'spearman', 'dice', 'wminkowski'])
def test_sparse_input_densifies(mode):
    """A CSR modality gives its dense copy's matrix in every mode outside
    the euclidean family."""
    x = _data(seed=4)
    np.testing.assert_array_equal(
        _np(td.dataset_distance_matrix(scipy.sparse.csr_matrix(x), mode,
                                       device='cpu')),
        _np(td.dataset_distance_matrix(x, mode, device='cpu')))


def test_wminkowski_blocks_and_weights():
    """Row blocks of any size give the unblocked matrix, and weights scale
    the coordinates, against a float64 build."""
    x = _data(n=23, seed=5)
    w = np.linspace(0.5, 2.0, x.shape[1]).astype(np.float32)
    ref = (np.abs((x[:, None].astype(np.float64) - x[None]) * w) ** 3
           ).sum(-1) ** (1 / 3)
    for block in (4, 256):
        ours = td._wminkowski_dist(torch.as_tensor(x), p=3.0, w=w,
                                   block=block).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
