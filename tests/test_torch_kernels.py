"""The port's kernels (K1/K2 prime-dual tail, K3 pairwise distance) against
jamie_tpu's Pallas kernels, run in interpret mode on the CPU as
tests/test_ab_archive.py runs them. On the CPU each wrapper takes its plain
PyTorch version; the kernels themselves are held against those plain
versions on the card in tests/test_torch_cuda.py and chip_smoke.py."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jamie_tpu.ops.ab_archive import (
    fused_pd_grad_update, fused_pd_update, pairwise_sq_euclidean_pallas,
)
from jamie_tpu_torch import ops
from jamie_tpu_torch.ops import (block_tail, pairwise, pd_update,
                                 shortest_paths)

M, N = 24, 136   # not tile-aligned on the TPU's sublane axis


def _bf16_round(a):
    return torch.as_tensor(a).bfloat16().float().numpy()


def _state(seed, m1_bf16):
    rng = np.random.RandomState(seed)
    st = dict(
        F=rng.rand(M, N), M1=rng.randn(M, N) * 0.1, M2=rng.rand(M, N) * 0.01,
        mm4=rng.randn(M, N), KxFKy=rng.randn(M, N), Mu=rng.randn(M, 1),
        Lambda=rng.randn(N, 1), S=rng.rand(N, 1), grad=rng.randn(M, N))
    st = {k: v.astype(np.float32) for k, v in st.items()}
    st['rowsum'] = st['F'].sum(1, keepdims=True)
    st['colsum'] = st['F'].sum(0, keepdims=True)
    if m1_bf16:   # both packages see the same bf16-representable values
        st['M1'] = _bf16_round(st['M1'])
        st['KxFKy'] = _bf16_round(st['KxFKy'])
    return st


def _torch_state(st, m1_bf16):
    # copies: the port's update writes F, M1, M2 in place, and jax may
    # still read the same host arrays
    t = {k: torch.tensor(v) for k, v in st.items()}
    if m1_bf16:
        t['M1'] = t['M1'].bfloat16()
        t['KxFKy'] = t['KxFKy'].bfloat16()
    return t


def _compare(ours, ref, m1_bf16):
    """F' and M2' at the Pallas test's rtol 1e-5 / atol 1e-7. A bf16 M1' is
    the f32 result rounded once, so it is within half a bf16 ulp (at most
    2^-8 relative: bf16 keeps 8 significant bits) of the Pallas f32 M1',
    plus f32 rounding."""
    F2, M1_2, M2_2 = (o.float().numpy() for o in ours)
    np.testing.assert_allclose(F2, np.asarray(ref[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(M2_2, np.asarray(ref[2]), rtol=1e-5, atol=1e-7)
    if m1_bf16:
        assert ours[1].dtype == torch.bfloat16
        np.testing.assert_allclose(M1_2, np.asarray(ref[1]), rtol=2 ** -8 + 1e-5,
                                   atol=1e-7)
    else:
        np.testing.assert_allclose(M1_2, np.asarray(ref[1]), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize('m1_bf16', [False, True])
def test_pd_grad_update_plain_matches_pallas(m1_bf16):
    st = _state(0, m1_bf16)
    ref = fused_pd_grad_update(
        *(jnp.asarray(st[k]) for k in ('F', 'M1', 'M2', 'mm4', 'KxFKy', 'Mu',
                                        'Lambda', 'S', 'rowsum', 'colsum')),
        jnp.asarray(0.7, jnp.float32), jnp.asarray(7, jnp.int32), 0.001, 10.0)
    t = _torch_state(st, m1_bf16)
    ours = pd_update.fused_pd_grad_update(
        t['F'], t['M1'], t['M2'], t['mm4'], t['KxFKy'], t['Mu'], t['Lambda'],
        t['S'], t['rowsum'], t['colsum'], torch.tensor(0.7), 7, 0.001, 10.0)
    _compare(ours, ref, m1_bf16)


@pytest.mark.parametrize('m1_bf16', [False, True])
def test_pd_update_plain_matches_pallas(m1_bf16):
    st = _state(1, m1_bf16)
    ref = fused_pd_update(jnp.asarray(st['F']), jnp.asarray(st['M1']),
                          jnp.asarray(st['M2']), jnp.asarray(st['grad']),
                          jnp.asarray(7, jnp.int32), 0.001)
    t = _torch_state(st, m1_bf16)
    ours = pd_update.fused_pd_update(t['F'], t['M1'], t['M2'], t['grad'], 7,
                                     0.001)
    _compare(ours, ref, m1_bf16)


def test_bias_corrections_are_float32():
    b1, b2 = pd_update.bias_corrections(7)
    assert b1 == float(np.float32(1) - np.float32(0.9) ** np.float32(7))
    assert np.float32(b2) == b2


@pytest.mark.parametrize('squared', [True, False])
def test_pairwise_plain_matches_pallas(squared):
    rng = np.random.RandomState(1)
    x = rng.randn(70, 33).astype(np.float32)
    y = rng.randn(50, 33).astype(np.float32)
    ref = np.asarray(pairwise_sq_euclidean_pallas(x, y, tile_m=32, tile_n=128,
                                                  tile_k=32))
    ours = pairwise.pairwise_euclidean(torch.as_tensor(x), torch.as_tensor(y),
                                       squared=squared).numpy()
    if squared:
        np.testing.assert_allclose(ours, ref, atol=1e-3)   # Gram cancellation
    else:
        np.testing.assert_allclose(ours ** 2, ref, atol=1e-3)


def test_pairwise_self_distance_zero_diag_and_symmetric():
    rng = np.random.RandomState(2)
    x = rng.randn(40, 10).astype(np.float32)
    ref = np.asarray(pairwise_sq_euclidean_pallas(x, tile_m=32, tile_n=128,
                                                  tile_k=32))
    for squared in (True, False):
        d = pairwise.pairwise_euclidean(torch.as_tensor(x),
                                        squared=squared).numpy()
        assert (np.diag(d) == 0).all()
        np.testing.assert_allclose(d, d.T, atol=1e-3)
        np.testing.assert_allclose(d if squared else d ** 2, ref, atol=1e-3)


def test_cpu_tensors_take_plain_path_and_count_nothing():
    ops.reset_launch_counts()
    st = _torch_state(_state(3, False), False)
    pd_update.fused_pd_grad_update(
        st['F'], st['M1'], st['M2'], st['mm4'], st['KxFKy'], st['Mu'],
        st['Lambda'], st['S'], st['rowsum'], st['colsum'], torch.tensor(1.0),
        1, 1e-3, 10.0)
    pd_update.fused_pd_update(st['F'], st['M1'], st['M2'], st['grad'], 1, 1e-3)
    pairwise.pairwise_euclidean(st['F'])
    shortest_paths.floyd_warshall(torch.zeros(
        (shortest_paths.TILE,) * 2, dtype=torch.float64))
    z, v = st['F'], torch.ones(N)
    y, stats = block_tail.block_tail_forward(z, v, v, v, v.clone(), v.clone(),
                                             None, 1.0, 0.9, 1e-5)
    block_tail.block_tail_backward(y, z, v, v, v, stats, None, 1.0)
    assert ops.launch_counts() == {'fused_pd_grad_update': 0,
                                   'fused_pd_update': 0,
                                   'pairwise_euclidean': 0,
                                   'floyd_warshall': 0,
                                   'block_tail_forward': 0,
                                   'block_tail_backward': 0}


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.zeros((4, 3), device='meta')
    with pytest.raises(ValueError):
        pairwise.pairwise_euclidean(x)
    with pytest.raises(ValueError):
        pd_update.fused_pd_update(x, x, x, x, 1, 1e-3)
    v = torch.zeros(3, device='meta')
    with pytest.raises(ValueError):
        block_tail.block_tail_forward(x, v, v, v, v, v, None, 1.0, 0.9, 1e-5)


def test_kernel_modules_import_without_triton():
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name == "triton" or name.startswith("triton."):\n'
        '            raise ImportError("blocked " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import jamie_tpu_torch.ops.pd_update, jamie_tpu_torch.ops.pairwise\n'
        'import jamie_tpu_torch.ops.block_tail\n'
        'print("ok")\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


# (m, n, f) -> (padded width, split-K factor) on a 132-SM H100: the fit's
# 1047^2 (81 tiles) splits its 3000/5000 features three ways; 9190^2 (5184
# tiles) and one-stage widths run whole; widths pad to a multiple of 4
@pytest.mark.parametrize('mnf, plan', [
    ((1047, 1047, 5000), (5000, 3)), ((1047, 1047, 3000), (3000, 3)),
    ((9190, 9190, 28930), (28932, 1)), ((1047, 1047, 32), (32, 1)),
    ((70, 50, 33), (36, 1)), ((1, 1, 4), (4, 1))])
def test_pairwise_launch_plan(mnf, plan):
    fp, splits = pairwise.launch_plan(*mnf, num_sms=132)
    assert (fp, splits) == plan
    steps = -(-fp // pairwise.K_STEP)
    per = -(-steps // splits)
    assert (splits - 1) * per < steps   # no empty slice (the kernel refuses one)
