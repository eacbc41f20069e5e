"""Kernels against their plain PyTorch versions on a CUDA card.

Marked `cuda`; each test skips without a card. This file imports neither
jax nor jamie_tpu, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from jamie_tpu_torch import evaluation, ops, probes
from jamie_tpu_torch.core import dtypes, residency
from jamie_tpu_torch.ops import distances, pairwise, pd_update
from jamie_tpu_torch.solvers import landmark

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
# 1047^2 and 1000x1037 are not multiples of the kernel's BLOCK; 1 x n and
# m x 1 put every entry in one row or one column
@pytest.mark.parametrize('shape', [(24, 136), (1047, 1047), (1000, 1037),
                                   (1037, 1037), (1, 1047), (1037, 1)])
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


@pytest.mark.parametrize('state_dtype', ['float32', 'bfloat16'])
def test_dense_solve_past_520m_entries_matches_plain(cuda, monkeypatch,
                                                     state_dtype):
    """A short dense solve at 24,000^2 = 576M entries, past jamie_tpu's
    520M landmark threshold and inside the port's dense band: each K1
    call of the solve is held against the plain version on the last 128
    rows of its inputs (the largest flat offsets), at
    test_pd_grad_update_kernel_matches_plain's tolerances."""
    # the submodule: jamie_tpu_torch.solvers binds the function prime_dual
    pdm = importlib.import_module('jamie_tpu_torch.solvers.prime_dual')
    n = 24_000
    Kx, Ky = (probes.distance_operand(n, s, cuda) for s in (0, 1))
    real, rows, checked = pdm.fused_pd_grad_update, slice(n - 128, n), []

    def k1(F, M1, M2, mm4, KxFKy, Mu, Lam, S, rowsum, colsum, a, i, eps,
           rho):
        got = real(F, M1, M2, mm4, KxFKy, Mu, Lam, S, rowsum, colsum, a, i,
                   eps, rho)
        want = pd_update.fused_pd_grad_update_plain(
            F[rows], M1[rows], M2[rows], mm4[rows], KxFKy[rows], Mu[rows],
            Lam, S, rowsum[rows], colsum, a, i, eps, rho)
        for g, w in zip(got, want):
            rtol = 8e-3 if w.dtype == torch.bfloat16 else 1e-5
            torch.testing.assert_close(
                g[rows].float(), w.float(), rtol=rtol,
                atol=1e-6 * float(w.float().abs().max()))
        checked.append(i)
        return got
    monkeypatch.setattr(pdm, 'fused_pd_grad_update', k1)
    ops.reset_launch_counts()
    F = pdm.prime_dual(Kx, Ky, dx=32, dy=32, epoch_pd=3, log_pd=3,
                       state_dtype=state_dtype, device=cuda)
    assert checked == [1, 2, 3]
    assert pd_update.fused_pd_grad_update.launches == 3
    assert F.shape == (n, n) and bool(torch.isfinite(F).all())


@pytest.mark.parametrize('shape', [(1047, 1047), (1037, 1037), (1, 1047),
                                   (1037, 1)])
def test_pd_update_kernel_matches_plain(cuda, shape):
    F, M2, grad = (_rand(cuda, *shape, seed=s) for s in (1, 2, 3))
    M1 = _rand(cuda, *shape, seed=4) - 0.5
    ops.reset_launch_counts()
    got = pd_update.fused_pd_update(F, M1, M2, grad, 7, 1e-3)
    assert pd_update.fused_pd_update.launches == 1
    want = pd_update.fused_pd_update_plain(F, M1, M2, grad, 7, 1e-3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))


def _check_pairwise(x, y, squared):
    got = pairwise.pairwise_euclidean(x, y, squared=squared)
    want = pairwise.pairwise_euclidean_plain(x, y, squared=squared)
    # 3xTF32 against exact float32 with Gram cancellation: held on the
    # squares, to 1e-5 of the norm scale
    scale = float((x * x).sum(1).max()) * 2
    g2, w2 = (got, want) if squared else (got * got, want * want)
    assert float((g2 - w2).abs().max()) <= 1e-5 * scale
    if y is None:
        # the tensor cores may sum (i, j) and (j, i) in other orders, so
        # symmetry holds within the tolerance; the diagonal is exactly 0
        assert float((g2 - g2.T).abs().max()) <= 1e-5 * scale
        assert bool((torch.diagonal(got) == 0).all())


# f = 33 and 333 are not multiples of 4 (the wrapper pads for TMA); 1 and
# 70 rows are smaller than a 128-row tile; 1047x1047x5000 takes the
# split-K route (test_pairwise_fit_shape_splits)
@pytest.mark.parametrize('squared', [True, False])
@pytest.mark.parametrize('self_dist', [True, False])
@pytest.mark.parametrize('mnf', [(70, 50, 33), (1000, 1037, 333),
                                 (1047, 1047, 5000), (1, 70, 33),
                                 (70, 1, 333), (1, 1, 4), (300, 129, 32)])
def test_pairwise_kernel_matches_plain(cuda, mnf, self_dist, squared):
    m, n, f = mnf
    x = torch.randn(m, f, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    y = None if self_dist else torch.randn(n, f, device=cuda)
    ops.reset_launch_counts()
    _check_pairwise(x, y, squared)
    assert pairwise.pairwise_euclidean.launches == 1


def test_pairwise_fit_shape_splits(cuda):
    """The fit's 1047x1047 tiles (81) leave SMs idle, so the plan splits the
    feature axis and the second pass runs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    fp, splits = pairwise.launch_plan(1047, 1047, 5000, sms)
    assert fp == 5000 and splits > 1
    assert 81 * splits >= sms


def test_pairwise_kernel_misaligned_base(cuda):
    """A contiguous view whose base is not 16-byte aligned goes through an
    aligned copy (TMA needs one)."""
    buf = torch.rand(1 + 200 * 64, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(3))
    x = buf[1:].view(200, 64)
    assert x.data_ptr() % 16 != 0
    for y in (None, x.flip(0).contiguous()):
        _check_pairwise(x, y, squared=True)


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


def _pair(n, f0, f1, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 8).astype(np.float32)
    x = (z @ rng.randn(8, f0) + 0.1 * rng.randn(n, f0)).astype(np.float32)
    y = (z @ rng.randn(8, f1) + 0.1 * rng.randn(n, f1)).astype(np.float32)
    return x, y


def _resolved_rows(x, lm, k):
    """Rows whose k-th and (k+1)-th nearest landmark (squared distance, in
    float64) differ by more than K3's 1e-5 of the norm scale: there the
    card and the CPU must pick the same k neighbours."""
    d2 = ((x[:, None, :].astype(np.float64) - lm[None]) ** 2).sum(-1)
    d2.sort(axis=1)
    scale = 2 * float((x.astype(np.float64) ** 2).sum(1).max())
    return d2[:, k] - d2[:, k - 1] > 1e-5 * scale


@pytest.mark.parametrize('layout', ['dense', 'sparse'])
def test_landmark_correspondence_card_matches_cpu(cuda, layout):
    """The same landmark solve on the card (K1, K3) and on the CPU (plain
    versions): identical FPS picks; on rows whose k-th/(k+1)-th landmark
    gap exceeds K3's error, interpolation weights within 1e-4 and the
    mixed factor U within 1e-3 of its largest entry (float32 solver,
    whose distance inputs differ at K3's 1e-5 of the norm scale)."""
    x, y = _pair(600, 50, 30, seed=0)
    kw = dict(n_landmarks=128, k_interp=8, epoch_pd=200, verbose=False,
              distance_mode='euclidean', precision='highest', seed=5,
              factor_layout=layout)
    picks = []
    for dev in (cuda, 'cpu'):
        rng = np.random.RandomState(5)
        picks.append([landmark._select_landmarks(d, 128, 'fps', rng, dev)
                      for d in (x, y)])
    for a, b in zip(*picks):
        np.testing.assert_array_equal(a, b)
    ops.reset_launch_counts()
    F_gpu = landmark.landmark_correspondence(x, y, device=cuda, **kw)
    # 2 landmark distance matrices + one weight block per modality
    assert pairwise.pairwise_euclidean.launches == 4
    assert pd_update.fused_pd_grad_update.launches == 200
    F_cpu = landmark.landmark_correspondence(x, y, device='cpu', **kw)
    ok_x = _resolved_rows(x, x[picks[1][0]], 8)
    ok_y = _resolved_rows(y, y[picks[1][1]], 8)
    assert ok_x.mean() > 0.9 and ok_y.mean() > 0.9
    v_gpu, v_cpu = F_gpu.v.cpu().numpy(), F_cpu.v.numpy()
    assert np.abs(v_gpu - v_cpu)[ok_y].max() <= 1e-4
    u_gpu, u_cpu = F_gpu.u.cpu().numpy(), F_cpu.u.numpy()
    assert np.abs(u_gpu - u_cpu)[ok_x].max() <= 1e-3 * np.abs(u_cpu).max()


def test_blocked_metrics_card_matches_cpu(cuda, monkeypatch):
    """Row-blocked FOSCTTM and kNN on the card: one K3 launch per block,
    and values within what K3's 1e-5-of-norm-scale distances can flip
    (FOSCTTM to 1e-4, label transfer to 0.005) of the CPU's."""
    rng = np.random.RandomState(1)
    a = rng.randn(2000, 32).astype(np.float32)
    b = (a + 0.6 * rng.randn(2000, 32)).astype(np.float32)
    labels = rng.randint(0, 4, 2000)
    monkeypatch.setattr(evaluation, '_FOSCTTM_BLOCK_ENTRIES', 2000 * 600)
    ops.reset_launch_counts()
    f_gpu = evaluation.test_closer([a, b], device=cuda)
    assert pairwise.pairwise_euclidean.launches == 4      # 600-row blocks
    acc_gpu, _ = evaluation.knn_label_transfer_accuracy(
        [a, b], [labels, labels], k=5, device=cuda)
    assert pairwise.pairwise_euclidean.launches == 8
    f_cpu = evaluation.test_closer([a, b], device='cpu')
    acc_cpu, _ = evaluation.knn_label_transfer_accuracy(
        [a, b], [labels, labels], k=5, device='cpu')
    assert abs(f_gpu - f_cpu) <= 1e-4 and abs(acc_gpu - acc_cpu) <= 5e-3


@pytest.mark.parametrize('rounded', [False, True])
def test_device_csr_card_matches_cpu(cuda, rounded, monkeypatch):
    """DeviceCSR's SpMMs (cuSPARSE), row norms and decode on the card
    against the same calls on the CPU, on the exact and the bf16 route:
    products within f32 summation order (1e-5 of sum |x||M|), the decode
    bit-identical."""
    if rounded:
        monkeypatch.setattr(residency, 'BF16_LINK_ELEMS', 1000)
    rng = np.random.RandomState(2)
    X = sp.random(3000, 500, density=0.03, format='csr', random_state=rng,
                  dtype=np.float32)
    M = rng.randn(500, 40).astype(np.float32)
    Q = rng.randn(3000, 12).astype(np.float32)
    g, c = residency.DeviceCSR(X, cuda), residency.DeviceCSR(X, 'cpu')
    assert g.bf16 == c.bf16 == rounded
    absX = abs(X)
    for got, want, scale in (
            (g.matmul(M), c.matmul(M), absX @ np.abs(M)),
            (g.matmul(M, 100, 2100), c.matmul(M, 100, 2100),
             absX[100:2100] @ np.abs(M)),
            (g.tmatmul(Q), c.tmatmul(Q), absX.T @ np.abs(Q)),
            (g.row_sq_sums(), c.row_sq_sums(),
             np.asarray(absX.multiply(absX).sum(1)).ravel())):
        assert np.all(np.abs(got.cpu().numpy() - want.numpy())
                      <= 1e-5 * scale + 1e-30)
    assert torch.equal(g.rows(5, 900).cpu(), c.rows(5, 900))


@pytest.mark.parametrize('route', ['resident', 'chunked'])
def test_large_distance_routes_card_match_cpu(cuda, route, monkeypatch):
    """The bf16-resident Gram and the feature-chunked Gram (thresholds
    patched) on the card against the CPU: the bf16 residencies
    bit-identical, squared distances within f32 summation order (1e-5 of
    the norm scale), zero diagonal."""
    monkeypatch.setattr(distances, '_FEATURE_CHUNK_THRESHOLD', 1000)
    monkeypatch.setattr(residency, 'BF16_LINK_ELEMS', 1000)
    if route == 'chunked':
        monkeypatch.setattr(residency, 'DEFAULT_BUDGET_BYTES', 0)
    rng = np.random.RandomState(4)
    x = np.maximum(rng.randn(600, 3000), 0).astype(np.float32)
    x[rng.rand(600, 3000) < 0.9] = 0
    for src in (x, sp.csr_matrix(x)):
        residency.clear_residency_cache()
        d = [distances.pairwise_distance(src, 'sqeuclidean', device=dev)
             .cpu() for dev in (cuda, 'cpu')]
        scale = 2 * float((x.astype(np.float64) ** 2).sum(1).max())
        assert float((d[0] - d[1]).abs().max()) <= 1e-5 * scale
        assert bool((d[0].diagonal() == 0).all())
    if route == 'resident':
        a = residency.build_resident_bf16(x, cuda).cpu()
        b = residency.build_resident_bf16(sp.csr_matrix(x), 'cpu')
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize('mode', ['cosine', 'correlation', 'spearman',
                                  'pearson', 'kulsinski', 'sokalmichener',
                                  'wminkowski', 'nan_euclidean', 'haversine'])
def test_device_metrics_card_match_cpu(cuda, mode):
    """The metrics computed in torch on the card against the CPU: within
    f32 summation order (1e-5 of the matrix's largest entry)."""
    rng = np.random.RandomState(6)
    x = (rng.rand(300, 2 if mode == 'haversine' else 400)
         * (rng.rand(300, 1) > 0.3)).astype(np.float32)
    d = [distances.dataset_distance_matrix(x, mode, device=dev).cpu()
         for dev in (cuda, 'cpu')]
    assert float((d[0] - d[1]).abs().max()) <= 1e-5 * float(d[1].abs().max())


def test_tsne_gradient_card_matches_cpu(cuda):
    """The t-SNE step's KL gradient with K3's distances against the plain
    version on the CPU, on a state 30 iterations in: within 1e-3 of its
    largest entry (3xTF32 against exact float32, through 1 / (1 + d^2))."""
    from jamie_tpu_torch.ops.distances import pairwise_distance
    from jamie_tpu_torch.solvers import tsne
    rng = np.random.RandomState(7)
    x = rng.randn(400, 20).astype(np.float32)
    P = tsne.joint_probabilities(pairwise_distance(x, device='cpu'), 30,
                                 device='cpu')
    P_dev = tsne.joint_probabilities(pairwise_distance(x, device='cpu'), 30,
                                     device=cuda)
    assert float((P_dev.cpu() - P).abs().max()) <= 1e-5 * float(P.max())
    init = [(1e-4 * rng.randn(400, 32)).astype(np.float32)] * 2
    Y, _ = tsne.project_tsne(None, [P, P], np.arange(400), np.arange(400),
                             output_dim=32, n_iters=30, init=init,
                             device='cpu')
    Y = torch.as_tensor(Y)
    for exag in (12.0, 1.0):
        g = tsne._kl_grad(P, Y, exag)
        g_dev = tsne._kl_grad(P.to(cuda), Y.to(cuda), exag).cpu()
        assert float((g_dev - g).abs().max()) <= 1e-3 * float(g.abs().max())


@pytest.mark.parametrize('train', [False, True])
def test_bf16_forward_card_matches_cpu(cuda, train):
    """compute_dtype bfloat16 on the card (cuBLAS bf16 GEMMs) against the
    same model on the CPU, the same noise injected in train mode: every
    output within 1e-2 of its largest entry (bf16 rounding orders, as
    between the port and jamie_tpu on the CPU), dtypes as on the CPU."""
    from jamie_tpu_torch.models import CoupledVAE
    rng = np.random.RandomState(9)
    xs = [rng.randn(64, d).astype(np.float32) for d in (40, 24)]
    corr = rng.rand(64, 64).astype(np.float32)
    noise = [torch.as_tensor(rng.randn(64, 8).astype(np.float32))
             for _ in xs]
    outs = []
    for dev in (cuda, torch.device('cpu')):
        m = CoupledVAE((40, 24), 8, dropout=0.0, seed=3,
                       compute_dtype=torch.bfloat16).to(dev).train(train)
        with torch.no_grad():
            out = m([torch.as_tensor(x, device=dev) for x in xs],
                    torch.as_tensor(corr, device=dev),
                    noise=[n.to(dev) for n in noise])
        outs.append([[t.cpu() for t in group] for group in out])
    for g_card, g_cpu in zip(*outs):
        for a, b in zip(g_card, g_cpu):
            assert a.dtype == b.dtype
            a, b = a.float(), b.float()
            assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max())


def test_occlusion_card_matches_cpu(cuda, tmp_path):
    """occlusion_impact_device's batched forward on the card against the
    CPU on one model (fitted on the CPU, loaded on both): the baseline and
    every impact within 1e-5 (float32, TF32 off), for both spaces. Both
    modalities carry noise, so no PCA column of the ground truth is
    rounding noise (a correlation with one would hang on the last bits)."""
    from jamie_tpu_torch import JAMIE
    from jamie_tpu_torch.evaluation import occlusion_impact_device
    rng = np.random.RandomState(10)
    z = rng.randn(200, 5).astype(np.float32)
    data = [np.maximum(z @ rng.randn(5, 60) + 0.3 * rng.randn(200, 60), 0),
            z @ rng.randn(5, 30) + 0.3 * rng.randn(200, 30)]
    data = [d.astype(np.float32) for d in data]
    fit = JAMIE(device='cpu', epoch_DNN=30, min_epochs=5, batch_size=64,
                pca_dim=(16, 12), use_f_tilde=False, use_early_stop=False,
                dropout=0.0, log_DNN=10_000)
    fit.fit_transform(dataset=data)
    path = str(tmp_path / 'm.npz')
    fit.save_model(path)
    card = JAMIE(device=cuda).load_model(path)
    for space in ('input', 'latent'):
        got = occlusion_impact_device(card, data[0], data[1],
                                      batch_features=16, space=space)
        want = occlusion_impact_device(fit, data[0], data[1],
                                       batch_features=16, space=space)
        assert abs(got[0] - want[0]) <= 1e-5
        assert np.abs(got[1] - want[1]).max() <= 1e-5


def test_resume_is_bit_exact_on_card(cuda, tmp_path):
    """On the card, 10 epochs + a snapshot + a resumed 10 equal the
    uninterrupted 20 bit for bit (the generator's state, dropout and the
    cuBLAS GEMMs included)."""
    from jamie_tpu_torch.config import JamieConfig
    from jamie_tpu_torch.models import CoupledVAE
    from jamie_tpu_torch.train.trainer import JamieTrainer
    rng = np.random.RandomState(11)
    x = [rng.randn(96, d).astype(np.float32) for d in (30, 20)]

    def trainer(epochs):
        cfg = JamieConfig(epoch_DNN=epochs, min_epochs=5, batch_size=32,
                          use_early_stop=False, log_DNN=1000, epoch_chunk=5)
        return JamieTrainer(cfg, CoupledVAE((30, 20), 8, dropout=0.3),
                            x, np.eye(96, dtype=np.float32),
                            np.zeros((96, 96), np.float32), device=cuda)
    whole = trainer(20)
    full = whole.fit()
    trainer(10).fit(checkpoint_dir=str(tmp_path), checkpoint_every=10)
    resumed = trainer(20)
    final = resumed.fit(state=resumed.restore_fit_state(
        str(tmp_path / 'epoch_10')))
    assert torch.equal(final.params, full.params)
    assert torch.equal(final.mu, full.mu) and torch.equal(final.nu, full.nu)
    for a, b in zip(resumed.final_embed(), whole.final_embed()):
        np.testing.assert_array_equal(a, b)


def test_device_memory_stats_on_card(cuda):
    """jamie_tpu's keys from torch.cuda.memory_stats / mem_get_info."""
    from jamie_tpu_torch.core.timing import device_memory_stats
    x = torch.ones(1 << 20, device=cuda)
    stats = device_memory_stats(cuda)
    assert set(stats) == {'bytes_in_use', 'peak_bytes_in_use', 'bytes_limit'}
    assert stats['peak_bytes_in_use'] >= stats['bytes_in_use'] >= x.numel() * 4
    assert stats['bytes_limit'] > stats['peak_bytes_in_use']


@pytest.mark.parametrize('squared', [True, False])
@pytest.mark.parametrize('cross', [False, True])
def test_pairwise_autograd_card_matches_plain_autograd(cuda, squared, cross):
    """K3's autograd Function on the card (forward through the kernel)
    against autograd through pairwise_euclidean_plain with a sqrt guarded
    at 0: values within 1e-5 of the norm scale on the squares, gradients
    within 1e-4 of their largest entry, and finite."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(700, 32, device=cuda, generator=g).requires_grad_(True)
    y = (torch.randn(500, 32, device=cuda, generator=g).requires_grad_(True)
         if cross else None)
    up = torch.randn(700, 500 if cross else 700, device=cuda, generator=g)
    ops.reset_launch_counts()
    d = pairwise.pairwise_euclidean_autograd(x, y, squared)
    assert pairwise.pairwise_euclidean.launches == 1
    d2 = pairwise.pairwise_euclidean_plain(x, y, squared=True)
    live = d2 > 0
    ref = d2 if squared else torch.where(
        live, torch.sqrt(torch.where(live, d2, 1.0)), 0.0)
    scale = 2 * float((x.detach() ** 2).sum(1).max())
    dd, rd = d.detach(), ref.detach()
    assert float((dd * dd - rd * rd).abs().max()
                 if not squared else (dd - rd).abs().max()) <= 1e-5 * scale
    inputs = (x,) if y is None else (x, y)
    got = torch.autograd.grad((d * up).sum(), inputs)
    want = torch.autograd.grad((ref * up).sum(), inputs)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_predict_knn_card_matches_cpu(cuda):
    """predict_knn through K3 on the card against the CPU route, on data
    whose k-th and (k+1)-th neighbours are far apart against K3's error
    (a column-major input, which the kernel takes only as a contiguous
    copy): equal within 1e-5 of the targets' scale."""
    from jamie_tpu_torch.utils import predict_knn
    rng = np.random.RandomState(13)
    x = np.asfortranarray(rng.randn(600, 300).astype(np.float32))
    y = rng.randn(600, 40).astype(np.float32)
    ops.reset_launch_counts()
    got = predict_knn(x, y, k=5, device=cuda)
    assert pairwise.pairwise_euclidean.launches >= 1
    want = predict_knn(x, y, k=5, device='cpu')
    assert np.abs(got - want).max() <= 1e-5 * np.abs(y).max()


def test_silhouette_card_matches_cpu(cuda):
    """figures.silhouette_samples with K3 sqrt distances on the card
    against the CPU route, on a column-major input: within 1e-5."""
    from jamie_tpu_torch.figures import silhouette_samples
    rng = np.random.RandomState(14)
    labels = rng.randint(0, 4, 900)
    x = np.asfortranarray((rng.randn(900, 32)
                           + 3 * rng.randn(4, 32)[labels]).astype(np.float32))
    ops.reset_launch_counts()
    got = silhouette_samples(x, labels, device=cuda)
    assert pairwise.pairwise_euclidean.launches >= 1
    want = silhouette_samples(x, labels, device='cpu')
    assert np.abs(got - want).max() <= 1e-5


def test_mmdma_opt_card_matches_cpu(cuda):
    """MMD-MA's batched Adam loop on the card against the CPU from the same
    injected initial a1, a2, 200 steps, bandwidths from mmdma_embed's
    median heuristic: embeddings within 1e-4 of their largest entry
    (float32, TF32 off; the same runs in float64 on the CPU differ by
    2.5e-6, while a bandwidth far below the median, 0.05 here, lets Adam
    amplify rounding to 4e-3)."""
    from jamie_tpu_torch.compare import _mmdma_opt
    rng = np.random.RandomState(15)
    z = rng.randn(256, 6)
    Ks = []
    for f in (50, 70):
        d = z @ rng.randn(6, f) + 0.3 * rng.randn(256, f)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        Ks.append(torch.as_tensor((d @ d.T).astype(np.float32)))
    a = [torch.as_tensor(rng.rand(4, 256, 16).astype(np.float32) * 1e-2)
         for _ in Ks]
    E0 = torch.cat([Ks[0] @ a[0][0], Ks[1] @ a[1][0]]).numpy()
    d2 = ((E0[:, None] - E0[None]) ** 2).sum(-1)
    med = float(np.sqrt(np.median(d2[d2 > 0])))
    hyper = [torch.tensor(v, dtype=torch.float32) for v in (
        [.25 * med, med, 4 * med, med], [1e-2, 1e-2, 1e-3, 1e-3],
        [1e-3, 1e-4, 1e-3, 1e-4])]
    outs = []
    for dev in (cuda, torch.device('cpu')):
        E1, E2, _ = _mmdma_opt(*(t.to(dev) for t in Ks + a + hyper), 16, 200)
        outs.append((E1.cpu(), E2.cpu()))
    for g, w in zip(*outs):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


# ---------------------------------------------------------------- the mesh
@pytest.fixture
def nccl_mesh(cuda):
    """A world-size-1 NCCL group and its ('data',) mesh, destroyed after
    the test."""
    from jamie_tpu_torch.core import mesh as cm
    mesh = cm.create_mesh((1,), ('data',), device_type='cuda')
    yield mesh
    cm.destroy_group()


def test_mesh_collectives_on_nccl(nccl_mesh):
    """The autograd collectives on a one-rank NCCL group: forward the
    identity of a single rank's whole, backward the adjoint's."""
    from jamie_tpu_torch.core import mesh as cm
    dev = torch.device('cuda')
    group = cm.axis_group(nccl_mesh, 'data')
    rows = cm.split_of(5, nccl_mesh, 'data')
    x = torch.randn(5, 3, device=dev, requires_grad=True)
    for y in (cm.all_reduce(x, group), cm.all_gather(x, rows),
              cm.reduce_scatter(x, rows), cm.copy_to(x, group),
              cm.reduce_from(x, group)):
        assert torch.equal(y, x)
        g, = torch.autograd.grad((y * y).sum(), x)
        torch.testing.assert_close(g, 2 * x)


def test_mesh_shards_run_k1_and_k3(nccl_mesh):
    """The mesh path on the card: K3 on the distance shard and K1 on the
    solver shard, against their plain versions."""
    rng = np.random.RandomState(3)
    x = rng.randn(301, 40).astype(np.float32)
    ops.reset_launch_counts()
    d = distances.pairwise_distance(x, 'euclidean', mesh=nccl_mesh)
    assert pairwise.pairwise_euclidean.launches == 1
    xt = torch.as_tensor(x, device='cuda')
    want = pairwise.pairwise_euclidean_plain(xt, None, squared=False)
    scale = float((xt * xt).sum(1).max()) * 2
    assert float((d * d - want * want).abs().max()) <= 1e-5 * scale
    assert bool((torch.diagonal(d) == 0).all())
    from jamie_tpu_torch.solvers.prime_dual import prime_dual
    K = d.cpu().numpy()
    ops.reset_launch_counts()
    F = prime_dual(K, K[::-1, ::-1].copy(), 40, 40, epoch_pd=50,
                   verbose=False, precision='highest', mesh=nccl_mesh)
    assert pd_update.fused_pd_grad_update.launches == 50
    F_cpu = prime_dual(K, K[::-1, ::-1].copy(), 40, 40, epoch_pd=50,
                       verbose=False, precision='highest', device='cpu')
    assert F.shape == (301, 301)
    assert float((F.cpu() - F_cpu).abs().max()) <= 1e-4 * float(
        F_cpu.abs().max())
