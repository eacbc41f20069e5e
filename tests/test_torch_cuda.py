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


@pytest.mark.parametrize('device_step', [False, True])
@pytest.mark.parametrize('m1_dtype', [torch.float32, torch.bfloat16])
# 1047^2 and 1000x1037 are not multiples of the kernel's BLOCK; 1 x n and
# m x 1 put every entry in one row or one column
@pytest.mark.parametrize('shape', [(24, 136), (1047, 1047), (1000, 1037),
                                   (1037, 1037), (1, 1047), (1037, 1)])
def test_pd_grad_update_kernel_matches_plain(cuda, shape, m1_dtype,
                                             device_step):
    """The step as a host int (copied to the card by the wrapper) or as
    the solver passes it, an int32 counter on the card, from which the
    plain version computes its bias corrections with torch.pow."""
    m, n = shape
    F, M2, mm4 = (_rand(cuda, m, n, seed=s) for s in (1, 2, 3))
    M1 = (_rand(cuda, m, n, seed=4) - 0.5).to(m1_dtype)
    kx = _rand(cuda, m, n, seed=5).to(m1_dtype)
    Mu, Lam, S = _rand(cuda, m, 1, seed=6), _rand(cuda, n, 1, seed=7), \
        _rand(cuda, n, 1, seed=8)
    args = (F, M1, M2, mm4, kx, Mu, Lam, S, F.sum(1, keepdim=True),
            F.sum(0, keepdim=True), torch.tensor(0.7, device=cuda),
            torch.tensor(7, dtype=torch.int32, device=cuda) if device_step
            else 7, 1e-3, 10.0)
    # both write F, M1, M2 in place: the plain version updates copies
    plain_args = tuple(t.clone() if j < 3 else t for j, t in enumerate(args))
    ops.reset_launch_counts()
    got = pd_update.fused_pd_grad_update(*args)
    want = pd_update.fused_pd_grad_update_plain(*plain_args)
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
        # both update in place: the plain version first, on copies of the
        # rows it checks
        want = pd_update.fused_pd_grad_update_plain(
            F[rows].clone(), M1[rows].clone(), M2[rows].clone(), mm4[rows],
            KxFKy[rows], Mu[rows], Lam, S, rowsum[rows], colsum, a, i, eps,
            rho)
        got = real(F, M1, M2, mm4, KxFKy, Mu, Lam, S, rowsum, colsum, a, i,
                   eps, rho)
        for g, w in zip(got, want):
            rtol = 8e-3 if w.dtype == torch.bfloat16 else 1e-5
            torch.testing.assert_close(
                g[rows].float(), w.float(), rtol=rtol,
                atol=1e-6 * float(w.float().abs().max()))
        checked.append(int(i))
        return got
    monkeypatch.setattr(pdm, 'fused_pd_grad_update', k1)
    ops.reset_launch_counts()
    # the eager route: the checks read the host inside each iteration
    F = pdm.prime_dual(Kx, Ky, dx=32, dy=32, epoch_pd=3, log_pd=3,
                       state_dtype=state_dtype, device=cuda, _eager=True)
    assert checked == [1, 2, 3]
    assert pd_update.fused_pd_grad_update.launches == 3
    assert F.shape == (n, n) and bool(torch.isfinite(F).all())


@pytest.mark.parametrize('shape', [(1047, 1047), (1037, 1037), (1, 1047),
                                   (1037, 1)])
def test_pd_update_kernel_matches_plain(cuda, shape):
    F, M2, grad = (_rand(cuda, *shape, seed=s) for s in (1, 2, 3))
    M1 = _rand(cuda, *shape, seed=4) - 0.5
    ops.reset_launch_counts()
    want = pd_update.fused_pd_update_plain(F.clone(), M1.clone(), M2.clone(),
                                           grad, 7, 1e-3)
    got = pd_update.fused_pd_update(F, M1, M2, grad, 7, 1e-3)
    assert pd_update.fused_pd_update.launches == 1
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


@pytest.mark.parametrize('case', ['diag', 'accumulate', 'hybrid_bf16'])
def test_captured_fit_equals_eager_on_card(cuda, tmp_path, case):
    """On the card a fit trains through the captured epoch graphs, and
    fit(eager=True) runs the same epoch body op by op: the two agree bit
    for bit in epochs_run, loss_history, epoch_losses, the metrics records
    (seconds and memory aside) and the final FitState, on a fit whose
    early stop lands inside a chunk (epoch 8 of 5-9) with
    dispatch_lookahead 3 and dropout on: 'diag' sampling, accumulated
    gradients (batch_step off) with the identity sentinel, and a half-mask
    hybrid prior with bfloat16 compute."""
    import json
    from jamie_tpu_torch.config import JamieConfig
    from jamie_tpu_torch.models import CoupledVAE
    from jamie_tpu_torch.train.trainer import JamieTrainer
    rng = np.random.RandomState(12)
    n = 96
    x = [rng.randn(n, d).astype(np.float32) for d in (30, 20)]
    F = rng.rand(n, n).astype(np.float32)
    P = {'diag': np.eye(n, dtype=np.float32), 'accumulate': 'identity',
         'hybrid_bf16': (np.arange(n) % 2).astype(np.float32)}[case]
    bf16 = case == 'hybrid_bf16'
    cfg = JamieConfig(epoch_DNN=40, min_epochs=5, batch_size=32,
                      epoch_chunk=5, log_DNN=1000, dispatch_lookahead=3,
                      use_early_stop=True, max_steps_without_increment=2,
                      min_increment=1e9, batch_step=case != 'accumulate',
                      compute_dtype='bfloat16' if bf16 else 'float32')
    out = {}
    for eager in (False, True):
        tr = JamieTrainer(cfg, CoupledVAE(
            (30, 20), 8, dropout=0.3, compute_dtype=(
                torch.bfloat16 if bf16 else torch.float32)), x, P, F,
            device=cuda)
        path = tmp_path / f'{eager}.jsonl'
        state = tr.fit(metrics_path=str(path), eager=eager)
        records = [{k: v for k, v in json.loads(line).items()
                    if k not in ('seconds', 'memory')}
                   for line in open(path)]
        out[eager] = (state, tr.loss_history, tr.epoch_losses,
                      tr.epochs_run, records, tr.graph_stats['route'])
    (cs, ch, cl, cr, crec, croute), (es, eh, el, er, erec, eroute) = (
        out[False], out[True])
    assert (croute, eroute) == ('captured', 'eager')
    assert cr == er == 9 and cs.stopped and cs.epoch == 9
    assert ch == eh and cl == el and crec == erec
    for name in ('params', 'mu', 'nu'):
        assert torch.equal(getattr(cs, name), getattr(es, name)), name
    assert torch.equal(cs.rng.cpu(), es.rng.cpu())
    for k in cs.batch_stats:
        assert torch.equal(cs.batch_stats[k], es.batch_stats[k]), k
    for name in ('count', 'best_running_loss', 'streak'):
        assert getattr(cs, name) == getattr(es, name), name


def test_fit_spans_on_card(cuda):
    """A captured fit's spans on the card: one capture for the solve and
    three for the trainer, each with its warm-up and record, whose seconds
    are the loops' warmup_s and capture_s; the replays timed on the device
    inside their phases; the device memory at each phase's close."""
    from jamie_tpu_torch import JAMIE
    from jamie_tpu_torch.core import graphs
    rng = np.random.RandomState(5)
    z = rng.randn(300, 6)
    data = [(z @ rng.randn(6, d) + 0.1 * rng.randn(300, d)).astype(
        np.float32) for d in (50, 20)]
    jm = JAMIE(epoch_DNN=12, min_epochs=4, epoch_chunk=5, batch_size=64,
               pca_dim=(16, 8), epoch_pd=30, log_pd=10, log_DNN=1000,
               use_early_stop=False, distance_mode='geodesic')
    jm.fit_transform(dataset=data)
    root = jm.trace
    corr, mapping = root.child('Correspondence'), root.child('Mapping')
    (pd,) = corr.find('prime_dual.replay')
    (pd_cap,) = pd.find('graphs.capture')
    assert pd_cap.counters['loop'] == 'prime_dual'
    assert pd.counters == {'steps': 30, 'replays': 29}
    stats = graphs.last_stats['prime_dual']
    assert stats['warmup_s'] == pd_cap.child('graphs.warmup').seconds
    assert stats['capture_s'] == pd_cap.child('graphs.record').seconds
    assert stats['kernel_nodes'] == pd_cap.counters['kernel_nodes'] > 0
    assert 0 < pd.device_s + pd_cap.seconds <= corr.seconds
    (tr,) = mapping.find('trainer.replay')
    caps = tr.child('trainer.capture').find('graphs.capture')
    assert [c.counters['loop'] for c in caps] == [
        'epoch_start', 'epoch_step', 'epoch_end']
    assert jm.trainer.graph_stats['capture_s'] == pytest.approx(sum(
        c.child('graphs.record').seconds for c in caps))
    assert tr.counters['steps'] == 12 * jm.trainer.len_dataloader
    assert 0 < tr.device_s <= mapping.child('Training').seconds
    for sp in root.walk():
        assert isinstance(sp.memory_allocated, int) is (
            sp is root or sp.name in ('Distance', 'Correspondence',
                                      'Mapping', 'Preprocessing',
                                      'Trainer setup', 'Training', 'Output'))
    assert len(root.find('distances.knn_graph')) == 2
    assert root.self_seconds < 0.01 * root.seconds


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


@pytest.mark.parametrize('precision,state_dtype', [
    ('default', 'float32'), ('highest', 'bfloat16')])
def test_mesh_prime_dual_captured_matches_eager(nccl_mesh, capsys,
                                                precision, state_dtype):
    """The mesh iteration captured with its NCCL collectives against the
    same iteration op by op (`_eager=True`) on a one-rank NCCL mesh: F bit
    for bit, the printed lines identical, K1 counted once per replay (45
    launches on each route), every step on its route."""
    from jamie_tpu_torch.core import graphs
    from jamie_tpu_torch.probes import distance_operand
    pdm = importlib.import_module('jamie_tpu_torch.solvers.prime_dual')
    dev = torch.device('cuda')
    Kx, Ky = distance_operand(300, 0, dev), distance_operand(300, 1, dev)
    kw = dict(epoch_pd=45, log_pd=10, delay=7, precision=precision,
              state_dtype=state_dtype, mesh=nccl_mesh)
    outs = []
    for eager in (False, True):
        graphs.loop_steps.clear()
        ops.reset_launch_counts()
        F = pdm.prime_dual(Kx, Ky, 32, 32, _eager=eager, **kw)
        torch.cuda.synchronize()
        assert pd_update.fused_pd_grad_update.launches == 45
        assert _steps('prime_dual') == {'mesh' if eager
                                        else 'mesh_captured': 45}
        outs.append((F, capsys.readouterr().out.splitlines()))
    assert outs[0][1] == outs[1][1] and len(outs[0][1]) == 4
    assert torch.equal(outs[0][0], outs[1][0])


def test_landmark_mesh_solve_runs_captured(nccl_mesh):
    """The landmark solve on a one-rank NCCL mesh goes through the captured
    mesh iteration (prime_dual(mesh=...)) and gives the unsharded
    factors bit for bit."""
    from jamie_tpu_torch.core import graphs
    x, y = _pair(600, 50, 30, seed=0)
    kw = dict(n_landmarks=128, k_interp=8, epoch_pd=100, verbose=False,
              seed=5, factor_layout='dense', device='cuda')
    graphs.loop_steps.clear()
    F_mesh = landmark.landmark_correspondence(x, y, mesh=nccl_mesh, **kw)
    assert _steps('prime_dual') == {'mesh_captured': 100}
    F = landmark.landmark_correspondence(x, y, **kw)
    assert torch.equal(F_mesh.u, F.u) and torch.equal(F_mesh.v, F.v)


@pytest.mark.parametrize('shape', [(1,), (1, 1)])
def test_mesh_fit_captured_equals_eager_on_card(cuda, tmp_path, shape):
    """A fit on a one-rank NCCL mesh, ('data',) and (1, 1) ('data',
    'model'), trains through the captured epoch graphs with the
    collectives inside them (under the IF node too) and equals
    fit(eager=True) bit for bit: epochs_run, history, metrics records and
    the final FitState, over an early stop inside a chunk with
    dispatch_lookahead 3 and dropout on."""
    import json
    from jamie_tpu_torch.config import JamieConfig
    from jamie_tpu_torch.core import mesh as cm
    from jamie_tpu_torch.models import CoupledVAE
    from jamie_tpu_torch.train.trainer import JamieTrainer
    rng = np.random.RandomState(12)
    n = 96
    x = [rng.randn(n, d).astype(np.float32) for d in (30, 20)]
    F = rng.rand(n, n).astype(np.float32)
    cfg = JamieConfig(epoch_DNN=40, min_epochs=5, batch_size=32,
                      epoch_chunk=5, log_DNN=1000, dispatch_lookahead=3,
                      use_early_stop=True, max_steps_without_increment=2,
                      min_increment=1e9)
    mesh = cm.create_mesh(shape, ('data', 'model')[:len(shape)],
                          device_type='cuda')
    try:
        out = {}
        for eager in (False, True):
            tr = JamieTrainer(cfg, CoupledVAE((30, 20), 8, dropout=0.3), x,
                              np.eye(n, dtype=np.float32), F, device=cuda,
                              mesh=mesh)
            path = tmp_path / f'{eager}.jsonl'
            state = tr.fit(metrics_path=str(path), eager=eager)
            records = [{k: v for k, v in json.loads(line).items()
                        if k not in ('seconds', 'memory')}
                       for line in open(path)]
            out[eager] = (state, tr.loss_history, tr.epoch_losses,
                          tr.epochs_run, records, tr.graph_stats['route'])
    finally:
        cm.destroy_group()
    (cs, ch, cl, cr, crec, croute), (es, eh, el, er, erec, eroute) = (
        out[False], out[True])
    assert (croute, eroute) == ('mesh_captured', 'mesh')
    assert cr == er and cs.stopped and cr % 5 != 0
    assert ch == eh and cl == el and crec == erec
    for name in ('params', 'mu', 'nu'):
        assert torch.equal(getattr(cs, name), getattr(es, name)), name
    assert torch.equal(cs.rng.cpu(), es.rng.cpu())
    for k in cs.batch_stats:
        assert torch.equal(cs.batch_stats[k], es.batch_stats[k]), k
    for name in ('count', 'best_running_loss', 'streak'):
        assert getattr(cs, name) == getattr(es, name), name


# ----------------------------------------------- captured solver loops
def _steps(name):
    from jamie_tpu_torch.core import graphs
    return {k.split('/')[1]: v for k, v in graphs.loop_steps.items()
            if k.startswith(name + '/')}


@pytest.mark.parametrize('precision,state_dtype', [
    ('default', 'float32'), ('default', 'bfloat16'), ('highest', 'float32')])
def test_prime_dual_captured_matches_eager(cuda, capsys, precision,
                                           state_dtype):
    """The captured iteration replayed against the same iteration run op
    by op on the card: F bit for bit, the printed lines identical, K1
    launched once per iteration on both routes (the replays counted), with
    delay 7 and 45 iterations in chunks of 10 (the last one 5)."""
    from jamie_tpu_torch.core import graphs
    from jamie_tpu_torch.probes import distance_operand
    pdm = importlib.import_module('jamie_tpu_torch.solvers.prime_dual')
    Kx, Ky = distance_operand(300, 0, cuda), distance_operand(300, 1, cuda)
    kw = dict(epoch_pd=45, log_pd=10, delay=7, precision=precision,
              state_dtype=state_dtype, device=cuda)
    outs = []
    for eager in (False, True):
        graphs.loop_steps.clear()
        ops.reset_launch_counts()
        F = pdm.prime_dual(Kx, Ky, 32, 32, _eager=eager, **kw)
        torch.cuda.synchronize()
        assert pd_update.fused_pd_grad_update.launches == 45
        assert _steps('prime_dual') == {'eager' if eager else 'captured': 45}
        outs.append((F, capsys.readouterr().out.splitlines()))
    stats = graphs.last_stats['prime_dual']
    assert stats['route'] == 'eager'
    assert outs[0][1] == outs[1][1] and len(outs[0][1]) == 4
    assert torch.equal(outs[0][0], outs[1][0])


def test_fps_captured_matches_eager_and_cpu(cuda):
    """One pick per replay: the same indices as the eager picks on the
    card and as the CPU's."""
    x = torch.randn(3000, 64, generator=torch.Generator().manual_seed(4))
    got = landmark._fps_indices_device(x.to(cuda), 17, 256)
    assert _steps('fps').get('captured', 0) >= 255
    eager = landmark._fps_indices_device(x.to(cuda), 17, 256, eager=True)
    cpu = landmark._fps_indices_device(x, 17, 256)
    assert torch.equal(got.cpu(), eager.cpu())
    assert torch.equal(got.cpu(), cpu)


def test_tsne_loops_captured_match_eager(cuda):
    """_calibrate_beta, _tsne_optimize (K3 twice a replay, counted) and
    _tsne_single captured against their eager steps: bit for bit."""
    from jamie_tpu_torch.solvers import tsne
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(300, 8, generator=g, device=cuda)
    D = pairwise.pairwise_euclidean(x, None, squared=True)
    betas = [tsne._calibrate_beta(D, 20.0, eager=e) for e in (False, True)]
    assert torch.equal(*betas)
    P = tsne.joint_probabilities(D.sqrt(), 20.0, device=cuda)
    Y0 = [1e-4 * torch.randn(300, 2, generator=g, device=cuda)
          for _ in range(2)]
    pairs = np.arange(300)
    runs = []
    for eager in (False, True):
        ops.reset_launch_counts()
        runs.append(tsne._tsne_optimize(P, P, *Y0, pairs, pairs, 10.0, 30,
                                        exaggeration_iters=12, eager=eager))
        assert pairwise.pairwise_euclidean.launches == 60
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    singles = [tsne._tsne_single(P, Y0[0], 30, exaggeration_iters=12,
                                 eager=e) for e in (False, True)]
    assert torch.equal(*singles)


def test_lowrank_captured_matches_eager(cuda):
    """Both low-rank phases captured (the masks drawn in the graph from the
    registered generator) against their eager steps: the binarized
    correspondence identical, and the generator's draws after the
    clustering phase too (the casting phase's initial a and F)."""
    from jamie_tpu_torch.solvers import lowrank as lr
    rng = np.random.RandomState(2)
    xs = rng.randn(80, 4)
    K = ((xs[:, None] - xs[None]) ** 2).sum(-1)
    outs = [lr.lowrank_corr(K, K[::-1, ::-1].copy(), dim=6, epochs=60,
                            device=cuda, _eager=e) for e in (False, True)]
    assert torch.equal(*outs)
    assert _steps('lowrank_cluster').get('captured', 0) >= 60


def test_umap_captured_matches_eager(cuda):
    """umap_embed with its bisection and its layout epochs captured (the
    negative partners drawn in the graph from the registered generator)
    against `_eager=True`: the embedding bit for bit, every step on its
    route."""
    from jamie_tpu_torch.core import graphs
    from jamie_tpu_torch.solvers import umap
    rng = np.random.RandomState(1)
    X = np.vstack([rng.randn(150, 12), rng.randn(150, 12) + 6.0]).astype(
        np.float32)
    outs = []
    for eager in (False, True):
        graphs.loop_steps.clear()
        outs.append(umap.umap_embed(X, 8, n_epochs=60, seed=3, device=cuda,
                                    _eager=eager))
        route = 'eager' if eager else 'captured'
        assert _steps('umap_sigma') == {route: 64}
        assert _steps('umap_layout') == {route: 60}
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(*outs)


def test_mmdma_captured_matches_eager(cuda):
    """_mmdma_opt's autograd + Adam step captured against the same step op
    by op on the card, over a batch of 4 runs: embeddings and MMD bit for
    bit."""
    from jamie_tpu_torch import compare
    g = torch.Generator().manual_seed(0)
    x = [torch.randn(120, f, generator=g) for f in (10, 7)]
    Ks = [(v / v.norm(dim=1, keepdim=True)).to(cuda) for v in x]
    Ks = [v @ v.T for v in Ks]
    a = [(torch.rand(4, 120, 6, generator=g) * 1e-2).to(cuda)
         for _ in range(2)]
    hyper = [torch.tensor(v, device=cuda) for v in (
        [0.1, 0.3, 0.6, 1.2], [1e-2, 1e-3, 1e-2, 1e-3],
        [1e-3, 1e-4, 1e-4, 1e-3])]
    outs = [compare._mmdma_opt(*Ks, *a, *hyper, 6, 40, _eager=e)
            for e in (False, True)]
    assert _steps('mmdma') == {'captured': 40, 'eager': 40}
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def _draw_and_capture(cuda):
    """The default CUDA generator draws, and a step that draws from it
    captures and replays."""
    from jamie_tpu_torch.core import graphs
    assert torch.isfinite(torch.rand(8, device=cuda)).all()
    gen = torch.Generator(device=cuda).manual_seed(1)
    y = torch.zeros(4, device=cuda)
    runner = graphs.steps_runner(
        'good', lambda: y.add_(torch.rand(4, device=cuda, generator=gen)),
        cuda, generators=[gen])
    runner.run(3)
    assert runner.graph is not None and bool((y > 0).all())


def test_failed_capture_raises(cuda, monkeypatch):
    """A step that reads the host cannot be captured: the loop raises, and
    nothing runs in its place. So for a bare step and for each of the
    UMAP bisection, the UMAP layout, MMD-MA, the mesh prime-dual and the
    mesh trainer with a host read put into its step: the warm-up step
    runs, the capture raises. After each raise the default CUDA generator
    draws and a good step captures (`graphs.end_failed_capture`)."""
    from jamie_tpu_torch import compare
    from jamie_tpu_torch.core import graphs
    from jamie_tpu_torch.solvers import umap
    g = torch.Generator().manual_seed(0)
    knn = torch.rand(50, 15, generator=g).sort(1).values.to(cuda)
    Y = torch.randn(50, 4, generator=g).to(cuda)
    W = torch.rand(50, 50, generator=g).to(cuda)
    a = torch.rand(2, 30, 3, generator=g).to(cuda)
    K = torch.eye(30, device=cuda)
    s = torch.ones(2, device=cuda)
    x = torch.ones(4, device=cuda)
    runner = graphs.steps_runner('bad', lambda: x.add_(float(x.sum())), cuda)
    with pytest.raises(RuntimeError):
        runner.run(3)
    assert torch.cuda.current_stream(cuda) == torch.cuda.default_stream(cuda)
    _draw_and_capture(cuda)

    def reads_host(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            float(args[1].sum())
            return out
        return wrapped
    graphs.loop_steps.clear()
    with monkeypatch.context() as m:
        m.setattr(umap, '_weight_sum', reads_host(umap._weight_sum))
        with pytest.raises(RuntimeError):
            umap._smooth_knn(knn, 10)
    with monkeypatch.context() as m:
        m.setattr(umap, '_repulsion', reads_host(umap._repulsion))
        with pytest.raises(RuntimeError):
            umap._optimize_layout(W, Y, torch.Generator(device=cuda), 10,
                                  1.5, 0.9)
    with monkeypatch.context() as m:
        m.setattr(compare, 'adam_update', reads_host(compare.adam_update))
        with pytest.raises(RuntimeError):
            compare._mmdma_opt(K, K, a, a, s, s, s, 3, 10)
    # each ran its eager warm-up step, then the capture raised
    for loop in ('umap_sigma', 'umap_layout', 'mmdma'):
        assert _steps(loop) == {'captured': 1}
    _draw_and_capture(cuda)

    # the mesh loops: a host read put in front of the first collective of
    # the prime-dual iteration and of the trainer's step (so no NCCL call
    # is left in a broken capture) makes each capture raise
    from jamie_tpu_torch.config import JamieConfig
    from jamie_tpu_torch.core import mesh as cm
    from jamie_tpu_torch.models import CoupledVAE
    from jamie_tpu_torch.solvers.prime_dual import prime_dual
    from jamie_tpu_torch.train.trainer import JamieTrainer
    def reads_host_first(fn):
        def wrapped(x, *args):
            float(x.sum())
            return fn(x, *args)
        return wrapped
    xs = [torch.randn(64, d, generator=g) for d in (12, 9)]
    mesh = cm.create_mesh((1,), ('data',), device_type='cuda')
    try:
        with monkeypatch.context() as m:
            m.setattr(cm, 'all_reduce_plain',
                      reads_host_first(cm.all_reduce_plain))
            with pytest.raises(RuntimeError):
                prime_dual(K, K, 3, 3, epoch_pd=5, verbose=False,
                           mesh=mesh)
        cfg = JamieConfig(epoch_DNN=3, batch_size=32, log_DNN=1000)
        tr = JamieTrainer(cfg, CoupledVAE((12, 9), 8), xs, 'identity',
                          'zeros', device=cuda, mesh=mesh)
        with monkeypatch.context() as m:
            m.setattr(cm, 'reduce_scatter_plain',
                      reads_host_first(cm.reduce_scatter_plain))
            with pytest.raises(RuntimeError):
                tr.fit()
    finally:
        cm.destroy_group()
    assert _steps('prime_dual') == {'mesh_captured': 1}
    _draw_and_capture(cuda)
