"""Entry points on one device and on a mesh of local processes.

Reference parity: `__graft_entry__.py` (`entry`, `dryrun_multichip`,
:22-269). jamie_tpu runs its multi-device dry run on a virtual 8-device
CPU mesh in one process; here `dryrun_multichip(n)` spawns n gloo ranks on
the CPU (`core.mesh.spawn_local`), each rank one process, and runs on an
(n/2, 2) data x model mesh (n odd: (n, 1)):

1. one training step with the tensor-parallel rule engaged (the threshold
   lowered to 32 for the tiny widths), the wide kernel checked split, the
   epoch loss checked finite and held to the unsharded step's;
2. the row-sharded distances (odd N) against the unsharded ones;
3. the row-sharded prime-dual solve (odd N, pad rows masked) against the
   unsharded one;
4. a tiny `fit_transform` (landmark F, a sparse half-observed prior) with
   mid-fit snapshots on the mesh, held to `use_mesh=False` within
   jamie_tpu's gate (1% of the embedding scale, cosine > 0.9999), and its
   last snapshot restored on one process.

Each rank checks that neither jax nor jamie_tpu was imported.

    python -c "from jamie_tpu_torch.multichip import dryrun_multichip; \\
        dryrun_multichip(4)"
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile

import numpy as np
import torch

from .core import mesh as cm


def _make_model_and_data(n=256, d0=512, d1=256, out=32, seed=0,
                         device='cpu'):
    from .models.coupled_vae import CoupledVAE
    rng = np.random.RandomState(seed)
    model = CoupledVAE((d0, d1), out, dropout=0.0, seed=seed).to(device)
    xs = [torch.as_tensor(rng.randn(n, d).astype(np.float32), device=device)
          for d in (d0, d1)]
    return model, xs, torch.eye(n, device=device)


def entry(device=None):
    """(fn, example_args): the eval-mode forward of the flagship coupled
    VAE; fn(x0, x1, corr) -> (z0, z1, x_hat0, x_hat1). On the card unless
    `device` names another (`core.dtypes.resolve_device`)."""
    from .core.dtypes import resolve_device
    model, xs, corr = _make_model_and_data(device=resolve_device(device))
    model.eval()

    @torch.no_grad()
    def forward(x0, x1, c):
        zs, _, x_hat, _, _ = model([x0, x1], c)
        return zs[0], zs[1], x_hat[0], x_hat[1]

    return forward, (xs[0], xs[1], corr)


def _check_no_jax() -> None:
    leaked = cm.modules_loaded('jax', 'jaxlib', 'flax', 'jamie_tpu')
    if leaked:
        raise RuntimeError(f'a mesh worker imported {leaked}')


def _train_step_check(mesh, n_devices: int) -> float:
    """One epoch of one step on the mesh, TP at threshold 32, against the
    same step unsharded; returns the epoch loss."""
    from .config import JamieConfig
    from .models.coupled_vae import CoupledVAE
    from .ops.lowrank import SparseLandmarkF
    from .train.trainer import JamieTrainer

    n = 8 * n_devices + 3            # odd: exercises pad-and-shard
    d0, d1 = 64, 16
    rng = np.random.RandomState(0)
    z = rng.randn(n, 4).astype(np.float32)
    x0 = (z @ rng.randn(4, d0)).astype(np.float32)
    x1 = (z @ rng.randn(4, d1)).astype(np.float32)
    P = np.eye(n, dtype=np.float32)
    F = SparseLandmarkF(
        np.stack([rng.choice(6, 3, replace=False) for _ in range(n)]),
        rng.rand(n, 3).astype(np.float32) * 0.1,
        np.stack([rng.choice(6, 3, replace=False) for _ in range(n)]),
        rng.rand(n, 3).astype(np.float32) * 0.1,
        rng.rand(6, 6).astype(np.float32), device='cpu')
    cfg = JamieConfig(epoch_DNN=1, min_epochs=0, batch_size=n,
                      epoch_chunk=1, use_early_stop=False, pca_dim=None,
                      log_DNN=10, tp_wide_threshold=32)
    losses = []
    for m in (mesh, None):
        tr = JamieTrainer(cfg, CoupledVAE((d0, d1), cfg.output_dim,
                                          dropout=0.0),
                          [x0, x1], P, F, device='cpu', mesh=m)
        if m is not None and cm.model_axis_size(m) > 1:
            k = tr.model.layers['enc0_b0'].dense.weight
            if tuple(k.shape) != (2 * d0 // cm.model_axis_size(m), d0):
                raise AssertionError(f'TP kernel not split: {tuple(k.shape)}')
        tr.fit()
        losses.append(tr.epoch_losses[0])
    if not np.isfinite(losses[0]):
        raise AssertionError(f'non-finite mesh loss {losses[0]}')
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    return float(losses[0])


def _estimator_check(mesh, n_devices: int, workdir: str) -> float:
    """fit_transform on the mesh with snapshots against use_mesh=False;
    the last snapshot restored into the unsharded fit's trainer. Returns
    max |delta| of the embeddings."""
    import scipy.sparse as sp
    from . import JAMIE

    n = 8 * n_devices + 5
    rng = np.random.RandomState(1)
    z = rng.randn(n, 4).astype(np.float32)
    xa = (z @ rng.randn(4, 24)).astype(np.float32)
    xb = (z @ rng.randn(4, 18)).astype(np.float32)
    obs = np.sort(rng.choice(n, n // 2, replace=False))
    P = sp.csr_matrix((np.ones(len(obs), np.float32), (obs, obs)),
                      shape=(n, n))
    kw = dict(epoch_DNN=30, min_epochs=0, epoch_chunk=10, batch_size=n,
              use_early_stop=False, pca_dim=[8, 8], dropout=0.0,
              corr_landmarks=8, corr_landmark_k=4,
              corr_factor_layout='sparse', epoch_pd=40, manual_seed=0,
              log_DNN=10_000, log_pd=10_000, device='cpu')
    ckpt = os.path.join(workdir, 'ck')
    jm = JAMIE(mesh=mesh, checkpoint_dir=ckpt, checkpoint_every=10, **kw)
    emb_mesh = jm.fit_transform(dataset=[xa, xb], P=P)
    torch.distributed.barrier()
    snaps = sorted(glob.glob(os.path.join(ckpt, 'epoch_*')),
                   key=lambda p: int(p.rsplit('_', 1)[1]))
    if not snaps:
        raise AssertionError('no snapshot written on the mesh')
    one = JAMIE(use_mesh=False, **kw)
    emb_one = one.fit_transform(dataset=[xa, xb], P=P)
    restored = one.trainer.restore_fit_state(snaps[-1])
    if restored.epoch != 30:
        raise AssertionError(f'last snapshot at epoch {restored.epoch}')
    delta = max(float(np.abs(a - b).max()) for a, b in zip(emb_mesh, emb_one))
    scale = max(float(np.abs(a).max()) for a in emb_one)
    # jamie_tpu's gate (__graft_entry__.py:257-266)
    if delta > 1e-2 * max(scale, 1.0):
        raise AssertionError(f'mesh vs one-device embeddings: max |delta| '
                             f'{delta:.3e} (scale {scale:.3e})')
    for a, b in zip(emb_mesh, emb_one):
        a, b = a.ravel(), b.ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        if cos <= 0.9999:
            raise AssertionError(f'embedding geometry diverged: cos {cos}')
    # the mesh's last snapshot, restored on one process, gives the mesh
    # fit's embeddings
    for a, b in zip(one.trainer.final_embed(restored), emb_mesh):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    return delta


def _dryrun_body(mesh, n_devices: int, workdir: str) -> dict:
    from .ops.distances import pairwise_distance
    from .solvers.prime_dual import prime_dual
    _check_no_jax()
    out = {'mesh': dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           'loss': _train_step_check(mesh, n_devices)}
    rng = np.random.RandomState(2)
    xd = rng.randn(8 * n_devices + 5, 9).astype(np.float32)
    ref = pairwise_distance(xd, device='cpu').numpy()
    got = pairwise_distance(xd, device='cpu', mesh=mesh).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    out['distance'] = float(np.abs(got - ref).max())
    xk = rng.randn(2 * n_devices + 1, 5).astype(np.float32)
    Kx = pairwise_distance(xk, device='cpu').numpy()
    kw = dict(dx=5, dy=5, epoch_pd=60, verbose=False, device='cpu')
    F_ref = prime_dual(Kx, Kx, **kw).numpy()
    F_sh = prime_dual(Kx, Kx, mesh=mesh, **kw).numpy()
    np.testing.assert_allclose(F_sh, F_ref, rtol=1e-4, atol=1e-6)
    out['prime_dual'] = float(np.abs(F_sh - F_ref).max())
    out['estimator'] = _estimator_check(mesh, n_devices, workdir)
    _check_no_jax()
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """Spawn n_devices gloo ranks on the CPU and run the mesh checks (the
    module docstring); returns rank 0's numbers and prints them."""
    n_model = 2 if n_devices % 2 == 0 else 1
    workdir = tempfile.mkdtemp(prefix='jamie_dryrun_')
    try:
        out = cm.spawn_local(_dryrun_body, n_devices, 'gloo',
                             (n_devices // n_model, n_model),
                             args=(n_devices, workdir))[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f'dryrun_multichip({n_devices}) ok: {out}')
    return out
