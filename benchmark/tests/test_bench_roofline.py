"""The yardstick's arithmetic against shapes worked by hand."""

import pytest

from roofline import coupled_vae, k1, k3, peaks, prime_dual

H100 = peaks('NVIDIA H100 80GB HBM3')


def test_peaks_table():
    assert H100 == {'bf16_flops': 989e12, 'tf32_flops': 495e12,
                    'fp32_flops': 67e12, 'hbm_bytes_per_s': 3.35e12}
    assert peaks('some other card') is None


def test_k1_bytes():
    # 32 bytes an entry in float32 (5 loads, 3 stores), 26 with bf16 M1
    # and KxFKy; 5 float32 vectors of m or n entries
    assert k1.bytes_per_call(10, 20, 'float32') == 200 * 32 + 4 * 80
    assert k1.bytes_per_call(10, 20, 'bfloat16') == 200 * 26 + 4 * 80
    # 9190^2: 2.70 GB, 0.807 ms at 3.35 TB/s
    assert k1.bound_s(9190, 9190, 'float32', H100) == pytest.approx(
        8.068e-4, rel=1e-3)


def test_k3_bound():
    assert k3.ops(3, 5, 7) == 3 * 2 * 3 * 5 * 7
    assert k3.bytes_per_call(3, 5, 7, True) == 4 * (21 + 15)
    assert k3.bytes_per_call(3, 5, 7, False) == 4 * (21 + 35 + 15)
    # 3654^2 x 1302: bound by the TF32 operations, 0.211 ms
    assert k3.bound_s(3654, 3654, 1302, True, H100) == pytest.approx(
        6 * 3654 ** 2 * 1302 / 495e12)
    assert 6 * 3654 ** 2 * 1302 / 495e12 > 4 * 3654 ** 2 / 3.35e12
    # 3654^2 x 39: bound by the 53.4 MB output
    assert k3.bound_s(3654, 3654, 39, True, H100) == pytest.approx(
        (3654 * 39 + 3654 ** 2) * 4 / 3.35e12)


def test_prime_dual_flops():
    assert prime_dual.flops_per_iteration(100, 100) == 8 * 100 ** 3
    assert prime_dual.flops_per_iteration(2, 3) == 6 * 2 * 9 + 2 * 4 * 3


def test_coupled_vae_step():
    assert coupled_vae.pca_width(3654, 39, 512) == 39
    assert coupled_vae.pca_width(9190, 28930, 512) == 512
    # one modality, in 4, out 2, batch 1: 8*16 + 3*4*2 = 152 MACs ->
    # 304 FLOPs, plus the mixing 2*2*1*1*2 = 8
    assert coupled_vae.forward_flops([4], 2, 1) == 304 + 8
    # scGLUE: 512-wide PCA on both arms, out 32, batch 512: 13.2 GFLOP
    assert coupled_vae.step_flops([512, 512], 32, 512) == pytest.approx(
        1.3289e10, rel=1e-3)


def _record(shapes, launches, state_dtype='float32', solve_shape=None):
    """A traced record whose fit solved at `solve_shape` (the dense
    route's (N0, N1) by default)."""
    import manifest
    trace = {'kernels': {'pd_update_kernel': (2e-3, 2),
                         'pairwise_tf32x3_kernel': (1e-3, 2)}}
    solve_shape = solve_shape or [shapes[0][0], shapes[1][0]]
    fit = {'launches': launches, 'solver_state_dtype': state_dtype,
           'solve_shape': solve_shape, 'epoch_pd': 100,
           'phases': {'Correspondence': 0.5}}
    return {'trace': trace, 'peaks': H100, 'fits': [fit],
            'config': {'shapes': shapes}}, manifest


@pytest.mark.parametrize('state_dtype', ['float32', 'bfloat16'])
def test_k1_reader_takes_the_fits_state_dtype(state_dtype):
    rec, manifest = _record([[100, 7], [120, 9]], {}, state_dtype)
    got = manifest.reader('k1_roofline')(rec)
    assert got == pytest.approx(
        100 * k1.bound_s(100, 120, state_dtype, H100) / 1e-3)


def _old_readings(rec):
    """The two solve readers' formulas as they read the configuration's
    (N0, N1) before the fit recorded its solve's shape."""
    (m, _), (n, _) = rec['config']['shapes']
    fit = rec['fits'][0]
    k1_pct = 100 * k1.bound_s(m, n, fit['solver_state_dtype'], H100) / 1e-3
    mfu = (100 * prime_dual.flops_per_iteration(m, n) * fit['epoch_pd']
           / fit['phases']['Correspondence'] / H100['bf16_flops'])
    return k1_pct, mfu


@pytest.mark.parametrize('state_dtype', ['float32', 'bfloat16'])
def test_solve_readers_on_a_dense_record_read_as_before(state_dtype):
    rec, manifest = _record([[9190, 28930], [9190, 241757]], {},
                            state_dtype)
    k1_pct, mfu = _old_readings(rec)
    assert manifest.reader('k1_roofline')(rec) == pytest.approx(k1_pct)
    assert manifest.reader('prime_dual.mfu')(rec) == pytest.approx(mfu)


@pytest.mark.parametrize('n0,n1', [(69249, 69249), (1500, 69249)])
def test_solve_readers_on_a_landmark_record_read_the_subproblem(n0, n1):
    """A landmark fit at L = 2048 solves at (min(L, N0), min(L, N1)) in
    float32 state, whatever its (N0, N1)."""
    L0, L1 = min(2048, n0), min(2048, n1)
    rec, manifest = _record([[n0, 13431], [n1, 116490]], {}, 'float32',
                            solve_shape=[L0, L1])
    assert manifest.reader('k1_roofline')(rec) == pytest.approx(
        100 * k1.bound_s(L0, L1, 'float32', H100) / 1e-3)
    assert manifest.reader('prime_dual.mfu')(rec) == pytest.approx(
        100 * prime_dual.flops_per_iteration(L0, L1) * 100 / 0.5
        / H100['bf16_flops'])
    # the configuration's shapes would count the whole (N0, N1)
    assert manifest.reader('k1_roofline')(rec) < _old_readings(rec)[0]


def test_k3_reader_takes_one_self_distance_a_modality():
    shapes = [[100, 7], [100, 9]]
    rec, manifest = _record(shapes, {k3.WRAPPER: 2})
    got = manifest.reader('k3_roofline')(rec)
    want = sum(k3.bound_s(n, n, f, True, H100) for n, f in shapes)
    assert got == pytest.approx(100 * want / 1e-3)
    # any other launch count has no known shapes: nothing to read
    for count in (0, 1, 3):
        rec, _ = _record(shapes, {k3.WRAPPER: count})
        assert manifest.reader('k3_roofline')(rec) is None
