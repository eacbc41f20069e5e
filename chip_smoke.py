#!/usr/bin/env python3
"""Smoke run of jamie_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi) and the versions.
2. Build: every kernel from the sources in this checkout (nvcc for
   csrc/*.cu, Triton's compiler for ops/pd_update.py).
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and larger ones, with the stated tolerance, its
   median time (CUDA events), the plain version's time, the least time the
   card could take (bound) and, for K3, one PyTorch call computing the same
   function (torch.cdist, which the port never calls). K3's MMA route and
   ptxas's report; a sweep of K1's block sizes; the device kernels that one
   K1 call and one K3 call issue (the kernel nodes of the call captured as a
   CUDA graph), held to 3 for K1 (its kernel and its bias corrections) and
   to the wrapper's stated count for K3. The atlas path's K3 shapes too: self
   sqrt on 2048-cell atlas landmark subsets (20,000 / 40,000 features) and
   one 2684-row block of the blocked FOSCTTM at 100,000 cells.
4. Fit: JAMIE().fit_transform at full width (default config, epoch_DNN cut
   to 20) on SNARE-seq-shaped synthetic data (1047 cells x 3000 RNA / 5000
   ATAC, seed 0), with every launch count and the trainer's epochs by
   route set to 0 just before it (every epoch must train captured); then
   FOSCTTM and label transfer, with the counts set to 0 again.
5. Serve: transform, modal_predict, save_model -> JAMIE().load_model ->
   identical modal_predict, with the counts set to 0 again; then a small
   prime-dual solve on the card held against the same solve on the CPU,
   for each precision and state dtype.
6. Partial prior: a short fit on the same data with the first fit's F
   (match_result, so no solve repeats) and P a 1-D mask with half the
   cells set, which must sample 'hybrid'.
7. Landmark fit: JAMIE(corr_landmarks=2048).fit_transform on 19,000
   SNARE-shaped cells (the same generator, seed 0) with the counts at 0:
   2000 K1 launches (the 2048x2048 solve), K3 for the landmark distances
   and the cell-to-landmark weights, a rank-2048 LowRankF, the identity
   sentinel P and 'diag' sampling. Then the row-blocked FOSCTTM and label
   transfer (one K3 launch per block, better than chance) and transform
   == the fit's output. Then the dense and k-sparse factor layouts of
   landmark_correspondence on the same data, held to each other, and a
   small landmark solve on the card held against the same solve on the
   CPU.
8. Sparse reference: DeviceCSR's SpMMs, row norms and decode on a
   3000 x 5000 CSR (3% nonzero, made on the card) against the CPU, on the
   exact and the bf16 route; the resident bf16 builds bit-identical.
9. Wide modality at the scGLUE shape: a 9190 x 241,757 0/1 CSR (5%
   nonzero) and a dense 9190 x 28,930 matrix through the bf16-resident and
   feature-chunked distance routes (held to each other and, on 256 rows,
   to float64) and the resident and column-streamed PCA (held by subspace
   cosine); the resident Gram timed.
10. Atlas fit: JAMIE(corr_landmarks=2048, pca_dim=(512, 512)) on the
   100,000-cell sparse multiome of examples/atlas_scale.py --sparse-data
   (20,000 / 40,000 features, 3% nonzero, made on the card, handed over as
   host CSR; epoch_DNN cut to 10), with the counts at 0: K1 2000 launches,
   K3 at least 2, the routes by `residency.route_counts`, a rank-2048
   LowRankF, the identity sentinel; exact FOSCTTM and LTA on 10,000 cells;
   transform and modal_predict on CSR; the SpMM's nonzeros per second.
11. t-SNE fit (D): JAMIE(project_mode='tsne') with every default on the
   1047-cell data, counts at 0: K1 2000, K3 2 + 2 per t-SNE iteration,
   the Hungarian pairs permutations, FOSCTTM within TSNE_FOSCTTM_LIMIT;
   its launch counts on a `tsne_launches` line.
12. t-SNE card vs CPU (D'): joint_probabilities, a 600-cell project_tsne
   and its KL gradient along the CPU's trajectory.
13. Nonlinear preclass (E): JAMIE(model_pca='umap'), then 'tsne' on the
   first fit's F, at pca_dim 512, with transform, modal_predict and a
   checkpoint round trip.
14. corr_method='jamie' (F): com_corr on the t-SNE fit's distances.
15. Metrics (G): every device metric on the RNA block against float64,
   every host-fallback metric at 300 x 200 with no sklearn.
16. t-SNE iteration time (H): project_tsne alone on the fit's P (1047
   cells) and at scGLUE's 9190 cells, against its bytes bound.
17. Raw-file workflow (I): the 1047-cell data as gzipped 10x triplets,
   read and normalized, a bf16-compute fit with snapshots and a metrics
   log (counts at 0: K1 2000, K3 >= 2), a float32 twin on its F, a resume
   from the epoch-10 snapshot bit-equal to the fit, the bf16 checkpoint
   served, occlusion over all 3000 genes, native SHAP and test_partial;
   one `workflow:` line (see workflow_phase).
18. Analysis and baselines (J): compare_methods on the 1047-cell data
   (NLMA, MMD-MA cut to 2001 iterations, UnionCom with every default on the
   raw modalities; LMA and CCA on PCA-512 views), each against jamie_tpu's
   CPU FOSCTTM where one exists; the singular raw LMA raising; predict_knn
   and predict_nn; the silhouette, knn_dist and gw_loss through K3's
   autograd Function, card against CPU or plain; MMD-MA card against CPU at
   256 cells; one `compare:` and one `analysis:` line (see compare_phase).
19. The mesh path (K): a world-size-1 NCCL group through a FileStore,
   the step-4 fit again through JAMIE(mesh=create_mesh((1,), ('data',)))
   and through a (1, 1) data x model mesh, counts at 0 (K1 2000, K3 >= 2),
   every iteration and epoch captured with its NCCL collectives, FOSCTTM
   and embeddings against step 4's, and each fit's eager twin (every loop
   op by op) bit-equal to it; a 2048^2 mesh prime-dual solve captured and
   eager, bit-equal, against the unsharded one; the mesh trainer's ms per
   step on both routes at phase P's 1047- and 9190-cell shapes; one
   `mesh:` line; the group destroyed.
20. The card's route thresholds (L): JAMIE() with no corr_landmarks on
   24,000 SNARE-shaped cells per side (576M entries) at full width,
   euclidean distances, epoch_pd cut to 50 and epoch_DNN to 2, counts at
   0: a dense (24000, 24000) F on the card, K1 50, K3 for RNA and the
   bf16-resident Gram for the 120M-element ATAC, the state dtype
   DENSE_F32_STATE_ENTRIES selects, the device peak and seconds per
   iteration, finite embeddings; one `thresholds:` line with every route
   global.
21. The bench twin (M): `jamie_tpu_torch.bench`'s train leg (one warm-up
   and one timed chunk of 20 epochs) and its pipeline leg once at the
   scGLUE shape (9190 cells x 28,930 / 241,757 features, binary ATAC
   z-scored per column, generated in memory), geodesic as bench runs it,
   epoch_DNN cut to 20, counts at 0: bench.py's record keys, K1 2000, the
   bf16-resident distance and PCA for both modalities, the 'identity' P
   sentinel, f32 solver state, F on the card, FOSCTTM under 0.5, the
   residency's upload 2 bytes a dense element; one `bench:` line.
22. The time-and-memory twin (N): `jamie_tpu_torch.time_and_memory.
   run_config` for the six other published shapes at full width,
   epoch_dnn 20 and min_epochs 0, counts at 0 before each: K1 2000, K3 or
   the resident Gram per modality, the state dtype, FOSCTTM under 0.5, the
   JAX harness's record keys; one `time_and_memory:` line. K1 and K3 are
   held to their plain versions at phases M's and N's shapes first.
23. The synthetic-data examples (O): each twin of
   `jamie_tpu_torch.examples` through its main, counts at 0 before each:
   sample with its own settings (K1 500, K3 >= 2 on the fit, FOSCTTM, LTA
   and imputation r within EXAMPLES_BAND of jamie_tpu's CPU values in
   EXAMPLES_REF, the checkpoint reloaded to an identical modal_predict),
   tuning (num_search 2, epoch_DNN 100: K1 300, the second fit reusing F),
   imputation_comparison (epoch_DNN 200: K1 500, K3 >= 2 from predict_knn,
   JAMIE's r per direction in its band, no figure without matplotlib),
   atlas_scale on 100,000 PCA-space cells ('diag', then 'hybrid' under
   --sparse-prior 0.5) and --sparse-data on 20,000 cells x 20,000 / 40,000
   features (K1 300, a rank-2048 LowRankF, FOSCTTM under 0.5, LTA above
   chance); K1 and K3 against their plain versions at these shapes first;
   one `examples:` line.
24. The captured trainer (P): every epoch since step 4 trained captured,
   on one device or on phase K's mesh, but those of phase K's eager twins;
   then the trainer's epochs
   replayed as CUDA graphs held bit for bit to its eager epoch body
   (fit(eager=True)) on full-width fits of the 1047-cell data (the default
   'diag' fit, batch_step=False, the half-mask hybrid prior, the identity
   sentinel with F 'zeros', a sparse prior with a top-32 sparse F,
   bfloat16 compute, an early stop inside a chunk under
   dispatch_lookahead=3) and of the 19,000-cell landmark data (LowRankF and
   SparseLandmarkF, 3 epochs): epochs_run, loss_history, epoch_losses, the
   metrics records and the final FitState; then ms per step, cells per
   second, the device's idle share over one epoch (torch.profiler) and
   device ops per step, eager and captured, at the bench train leg's, the
   scGLUE pipeline's and the 100,000-cell atlas trainer's shapes; one
   `train_capture:` line.
25. The captured solver loops (Q): every solver loop since step 4 (the
   prime-dual iterations, FPS picks, the t-SNE bisection and optimizers,
   both low-rank phases, UMAP's sigma bisection and layout epochs, MMD-MA's
   batched optimizer) ran as replays of a captured CUDA graph, phase K's
   mesh solves with their collectives, but the iterations of phase K's
   eager twins; then each loop's captured route held bit for
   bit to its eager step on the card: prime-dual at 300^2, 1047^2, 2048^2,
   3654^2 and 9190^2 (float32 and bfloat16 state, delay 50, 110
   iterations in chunks of 50; the printed lines identical, K1 110 times
   on each route), FPS on the 19,000-cell PCA-512 scores (2048 picks),
   t-SNE at 1047 and 9190 cells (K3 twice an iteration), low-rank at 1047
   cells, the UMAP bisection on the 1047-cell data's kNN distances, the
   UMAP layout at 1047 x 512 and 9190 x 512, MMD-MA on the 1047-cell data
   (36 runs, 200 iterations); ms per step on each route, capture seconds,
   kernel nodes, graph launches per step and the device peak; then a
   step that reads the host fails to capture, and after it the default
   CUDA generator draws and a step drawing from a generator captures and
   replays; one `solver_capture:` line (see solver_capture_phase).
26. The real-data examples (R): the twins of examples/scgem.py,
   comparison.py, imputation_comparison.py --scgem, scmnc_motor.py
   --partial, scmnc_motor_sweep.py (2 transforms, 1 seed),
   motor_provenance_fingerprint.py (--confirm, geodesic and euclidean) and
   scmnc_visual.py --partial, each through its main on synthetic files in
   the datasets' formats at the published widths (scGEM 177 x 230 / 27
   text, the motor .rda 1208 x 1286 / 29, the visual CSVs 3654 x 1302 /
   39), and scglue.run on 2048 cells at 28,930 / 241,757 features made in
   memory; epoch_DNN cut to 100, epoch_pd 2000 kept, the cuts on a
   `phase R: cuts:` line; counts at 0 before each twin: K1 2000 a fit
   (20,000 for UnionCom), K3 launched, the example's record keys, every
   FOSCTTM under 0.5, every number finite; one `examples_data:` line (see
   examples_data_phase).
27. A `kernels` JSON line (with each kernel's launches on the fit, bench,
   time-and-memory, examples, captured-loop and real-data-example paths),
   the nvidia-smi line, and as the last line {"ok": true, "device":
   {...}}.

Any failure ends the run with a non-zero exit code before the last line.
It exits non-zero without a result when no CUDA device is visible or when
the jamie_tpu_torch package is not next to it.
"""

import contextlib
import csv
import gzip
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published dense peaks (NVIDIA data sheet) of each card this script has run
# on, by torch.cuda.get_device_name: bytes/s of device memory, float32
# FLOP/s outside the tensor cores, and dense TF32 and bf16 FLOP/s on the
# tensor cores.
PEAKS = {
    'NVIDIA H100 80GB HBM3': (3.35e12, 67e12, 495e12, 989e12),   # H100 SXM
}


# The atlas fit's embeddings come from the PCA sketch's scores (Q Ub s);
# transform re-projects the CSR inputs by SpMM through the bf16-rounded
# components. The two differ by the part of the data outside the sketch's
# range, so transform is held to the fit output at this share of the
# output's largest entry (tests/test_torch_sparse_data.py holds the same
# routes at 300 cells to 5%), and its FOSCTTM to the fit's within 0.01.
TRANSFORM_REL = 0.15

# Phase D's FOSCTTM limit: jamie_tpu's own value on this generator on the
# CPU (0.5336, JAMIE(project_mode='tsne') with every default) + 0.05. The
# projection aligns the Hungarian pairs of the unsupervised F, and on this
# data almost none of them is the true cell, so neither package integrates
# it better than chance.
TSNE_FOSCTTM_LIMIT = 0.5836

# Phase J's references: jamie_tpu's own FOSCTTM on this generator's 1047
# cells on the CPU (jamie_tpu.compare, output_dim 32): NLMA on the raw
# modalities, LMA and CCA on jamie_tpu's Preprocessor PCA-512 views (on the
# raw 3000 + 5000 features their B = Z^T D Z is singular). The port must
# land within COMPARE_FOSCTTM_TOL of each.
COMPARE_FOSCTTM_REF = {'NLMA': 5.929526196268853e-06, 'LMA': 0.0, 'CCA': 0.0}
COMPARE_FOSCTTM_TOL = 0.02

# Phase K's limits: a mesh fit against the unsharded fit of the same run
# (tests/test_torch_mesh.py's auto-mesh tolerances on the CPU) and the
# 2048^2 mesh solve against the unsharded one, at 1e-4 of F's largest entry
# (the card-vs-CPU solver tolerance of phase 5).
MESH_EMBED_RTOL, MESH_EMBED_ATOL, MESH_FOSCTTM_TOL = 5e-2, 5e-3, 0.02
MESH_PD_REL = 1e-4

# Phase O's references: jamie_tpu's own values on the CPU at the same
# settings (examples/sample.py's fit as it stands; the imputation flow of
# examples/imputation_comparison.py at epoch_DNN 200, min_epochs 50). The
# port's twins on the CPU gave 3.3e-5, 1.0, 0.99353 and (0.98731, 0.98785).
# Each twin's value on the card must land within EXAMPLES_BAND of them.
EXAMPLES_REF = {
    'sample': {'foscttm': 1.1111111234640703e-05,
               'label_transfer_accuracy': 1.0,
               'mean_imputation_r': 0.9936676274513018},
    'imputation_comparison': {'jamie_r': (0.9867431108862583,
                                          0.9870351660296348)},
}
EXAMPLES_BAND = {'foscttm': 0.01, 'label_transfer_accuracy': 0.02,
                 'mean_imputation_r': 0.02, 'jamie_r': 0.02}


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def peaks_for(name):
    if name not in PEAKS:
        fail(f'no published peaks for {name!r}; add them to PEAKS')
    return PEAKS[name]


def time_ms(torch, fn):
    """(device_ms, call_ms): median ms per call from CUDA events.

    call_ms times the calls as the host issues them, so a short call
    measures the host's launch overhead. device_ms queues the same calls
    behind a GPU sleep long enough for the host to enqueue all of them, so
    the card runs them back to back: the card's own time per call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t
    inner = max(1, min(50, int(5e-3 / max(one, 1e-6))))
    reps = 5 if one > 0.05 else 11
    dev, call = [], []
    for _ in range(reps):
        for out, sleep in ((call, 0), (dev, one < 5e-3)):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            if sleep:   # ~2e9 cycles/s, twice the host's enqueue time
                torch.cuda._sleep(int(2 * inner * one * 2e9))
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop) / inner)
    return statistics.median(dev), statistics.median(call)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


class KernelPhase:
    """Hold each kernel against its plain version and time both."""

    def __init__(self, torch, bw, fp32, tf32, bf16):
        self.torch = torch
        self.bw, self.fp32, self.tf32, self.bf16 = bw, fp32, tf32, bf16
        self.dev = torch.device('cuda')
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        self.rows = []

    def bound(self, bytes_, flops, rate):
        t_bytes, t_ops = bytes_ / self.bw * 1e3, flops / rate * 1e3
        return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')

    def record(self, kernel, case, err, check, tol, ms, plain_ms, bytes_,
               flops, library_ms=None, rate=None, **extra):
        """err: max |kernel - plain|; check: the quantity held to tol; ms,
        plain_ms, library_ms: (device_ms, call_ms) pairs from time_ms;
        flops at `rate` (default: float32 on the CUDA cores)."""
        bound_ms, bound_by = self.bound(bytes_, flops, rate or self.fp32)
        row = dict(kernel=kernel, case=case, max_abs_err=err, check=check,
                   tol=tol, ms=ms[0], plain_ms=plain_ms[0], bound_ms=bound_ms,
                   bound_by=bound_by,
                   library_ms=None if library_ms is None else library_ms[0],
                   call_ms=ms[1], plain_call_ms=plain_ms[1],
                   library_call_ms=None if library_ms is None else library_ms[1],
                   **extra)
        self.rows.append(row)
        print('kernel ' + json.dumps(row), flush=True)
        if not check <= tol:
            fail(f'{kernel} {case}: {check} exceeds the tolerance {tol}')

    def pd_update(self, m, n, m1_dtype, has_grad=True, plain_rows=None):
        """K1 (or K2) at (m, n) against its plain version; with plain_rows
        the plain version runs, and is timed, on the last plain_rows rows
        only (at sizes where its temporaries do not fit beside the
        kernel's operands)."""
        torch = self.torch
        from jamie_tpu_torch.ops import pd_update as K
        g, dev = self.gen, self.dev

        def r(*shape, scale=1.0):
            return torch.rand(*shape, device=dev, generator=g) * scale

        F = r(m, n, scale=1e-3)
        M1 = (r(m, n) - 0.5).to(m1_dtype)
        M2 = r(m, n)
        S, Mu, Lam = r(n, 1), r(m, 1) - 0.5, r(n, 1) - 0.5
        rs, cs = F.sum(1, keepdim=True), F.sum(0, keepdim=True)
        mm4, kx = r(m, n), r(m, n).to(m1_dtype)
        a = torch.tensor(0.8, device=dev)
        # the step as the solver passes it: an int32 counter on the card,
        # from which the wrapper and the plain version compute Adam's bias
        # corrections there (torch.pow)
        i = torch.tensor(7, dtype=torch.int32, device=dev)
        eps, rho = 1e-3, 10.0
        if has_grad:
            name = 'pd_grad_update'
            args = (F, M1, M2, mm4, kx, Mu, Lam, S, rs, cs, a, i, eps, rho)
            kern, plain = K.fused_pd_grad_update, K.fused_pd_grad_update_plain
            ins = (F, M1, M2, mm4, kx, rs, cs, a, i)
            flops = 22 * m * n
        else:
            name = 'pd_update'
            args = (F, M1, M2, mm4, i, eps)
            kern, plain = K.fused_pd_update, K.fused_pd_update_plain
            ins = (F, M1, M2, mm4, i)
            flops = 17 * m * n
        sl = slice(m - (plain_rows or m), m)
        # the operands indexed by row: F, M1, M2, mm4 (and K1's KxFKy, Mu
        # and row sums), sliced to the last rows for the plain version;
        # both versions update F, M1, M2 in place, so the plain version
        # gets copies of them and runs first
        by_row = (0, 1, 2, 3, 4, 5, 8) if has_grad else (0, 1, 2, 3)
        plain_args = tuple(t[sl] if plain_rows and j in by_row else t
                           for j, t in enumerate(args))
        plain_args = tuple(t.clone() if j < 3 else t
                           for j, t in enumerate(plain_args))
        want = plain(*plain_args)
        got = tuple(t[sl] for t in kern(*args))
        torch.cuda.synchronize()
        # Elementwise |kernel - plain| <= atol + rtol |plain|: rtol 1e-5 for
        # f32 outputs (division/sqrt order, FMA contraction); a bf16 M1' may
        # land one bf16 ulp (<= 2^-7 relative) away, so rtol 8e-3 there.
        err, worst = 0.0, 0.0
        for k_out, p_out in zip(got, want):
            rtol = 8e-3 if p_out.dtype == torch.bfloat16 else 1e-5
            k_out, p_out = k_out.float(), p_out.float()
            diff = (k_out - p_out).abs()
            atol = 1e-6 * float(p_out.abs().max()) + 1e-12
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff / (atol + rtol * p_out.abs())).max()))
        out_bytes = nbytes(*got) * m // (sl.stop - sl.start)
        del got, want
        ms = time_ms(torch, lambda: kern(*args))
        plain_ms = time_ms(torch, lambda: plain(*plain_args))
        case = f'{m}x{n} M1={str(m1_dtype).split(".")[-1]}'
        if plain_rows:
            case += f' (plain on the last {plain_rows} rows)'
        self.record(name, case, err, worst, 1.0, ms, plain_ms,
                    nbytes(*ins) + out_bytes, flops)
        return kern, args

    def pairwise(self, x, y, squared):
        torch = self.torch
        from jamie_tpu_torch.ops.pairwise import (pairwise_euclidean,
                                                  pairwise_euclidean_plain)
        got = pairwise_euclidean(x, y, squared=squared)
        want = pairwise_euclidean_plain(x, y, squared=squared)
        torch.cuda.synchronize()
        xsq = (x * x).sum(1)
        ysq = xsq if y is None else (y * y).sum(1)
        # Gram cancellation: both compute |x|^2 + |y|^2 - 2 x.y in float32
        # with different summation orders, so the squared distances agree to
        # 1e-5 of the norm scale; sqrt outputs are held on their squares.
        tol = 1e-5 * float(xsq.max() + ysq.max())
        err = float((got - want).abs().max())
        check = err if squared else float((got * got - want * want).abs().max())
        ms = time_ms(torch, lambda: pairwise_euclidean(x, y, squared=squared))
        plain_ms = time_ms(
            torch, lambda: pairwise_euclidean_plain(x, y, squared=squared))
        yy = x if y is None else y
        # torch.cdist returns the sqrt; no one PyTorch call returns squared
        # distances, so squared rows carry cdist's time marked as such
        library_ms = time_ms(torch, lambda: torch.cdist(x, yy))
        m, f = x.shape
        n = yy.shape[0]
        ins = (x, xsq) if y is None else (x, y, xsq, ysq)
        case = (f'{m}x{n}x{f} {"self" if y is None else "cross"} '
                f'{"squared" if squared else "sqrt"}')
        # 3xTF32: three TF32 tensor-core products per float32-accurate one;
        # the CUDA cores' float32 bound is kept beside it
        fp32_bound_ms = self.bound(nbytes(*ins, got), 2 * m * n * f,
                                   self.fp32)[0]
        sym = (None if y is not None else
               float((got - got.T).abs().max()))
        if sym is not None and not (sym <= tol
                                    and bool((got.diagonal() == 0).all())):
            fail(f'K3 {case}: asymmetry {sym} (tolerance {tol}) or a '
                 f'non-zero diagonal')
        self.record('pairwise_euclidean', case, err, check, tol, ms, plain_ms,
                    nbytes(*ins, got), 3 * 2 * m * n * f, library_ms,
                    rate=self.tf32, fp32_bound_ms=fp32_bound_ms,
                    max_asymmetry=sym, library_output='sqrt')


def device_kernels(torch, fn):
    """(kernel nodes, kernel wrapper launches by name) of one call of fn,
    captured as a CUDA graph by core/graphs.StepGraph after its eager
    warm-up call: every kernel the call enqueues is a node of the graph, so
    the count does not depend on a profiler trace delivering its events."""
    from jamie_tpu_torch.core import graphs
    sg = graphs.StepGraph('device_kernels', fn, torch.cuda.current_device())
    sg.run(1)
    graphs.last_stats.pop('device_kernels', None)
    graphs.loop_steps.pop('device_kernels/captured', None)
    return sg.stats['kernel_nodes'], sg.stats['launches_per_step']


def mma_route(lib_path):
    """K3's tensor-core instruction, read from the built library's SASS
    (cuobjdump): HGMMA is wgmma, HMMA is mma.sync."""
    import shutil
    import triton
    cands = ('/usr/local/cuda/bin/cuobjdump', shutil.which('cuobjdump'),
             os.path.join(os.path.dirname(triton.__file__), 'backends',
                          'nvidia', 'bin', 'cuobjdump'))
    for cand in cands:
        if cand and os.path.isfile(cand):
            sass = subprocess.run([cand, '-sass', str(lib_path)],
                                  capture_output=True, text=True).stdout
            n_wgmma, n_mma = sass.count('HGMMA'), sass.count('HMMA')
            route = 'wgmma' if n_wgmma else ('mma.sync' if n_mma else 'none')
            return route, f'{n_wgmma} HGMMA, {n_mma} HMMA in the SASS'
    return 'unknown', 'cuobjdump not found'


def partial_prior_phase(JAMIE, ops, match_result, data):
    """A short fit reusing `match_result` (no solve) with P a 1-D mask of
    half the cells: 'hybrid' sampling and finite embeddings."""
    n = data[0].shape[0]
    mask = np.zeros(n, np.float32)
    mask[::2] = 1
    jp = JAMIE(match_result=match_result, epoch_DNN=5, min_epochs=2,
               use_early_stop=False)
    ops.reset_launch_counts()
    t = time.perf_counter()
    emb = jp.fit_transform(dataset=data, P=mask)
    print(f'partial prior: 1-D mask P with {int(mask.sum())} of {n} cells, '
          f'{time.perf_counter() - t:.3f} s, sampling '
          f'{jp.sampling_method!r}; launches {ops.launch_counts()}',
          flush=True)
    if jp.sampling_method != 'hybrid':
        fail(f'a half mask P sampled {jp.sampling_method!r}, not hybrid')
    if not all(e.shape == (n, 32) and np.isfinite(e).all() for e in emb):
        fail('partial-prior embeddings are off')


def landmark_fit_phase(torch, JAMIE, ops, data, labels, n_landmarks=2048):
    """JAMIE(corr_landmarks=...).fit_transform with the counts at 0 just
    before it, its row-blocked metrics with the counts at 0 again, and
    transform == the fit's output. Returns the fit's training data (its
    PCA-512 scores on the card)."""
    from jamie_tpu_torch import evaluation
    from jamie_tpu_torch.ops.lowrank import LowRankF, SparseLandmarkF
    n = data[0].shape[0]
    jm = JAMIE(corr_landmarks=n_landmarks, epoch_DNN=20, min_epochs=10,
               use_early_stop=False)
    ops.reset_launch_counts()
    t = time.perf_counter()
    out = jm.fit_transform(dataset=data)
    fit_s = time.perf_counter() - t
    counts = ops.launch_counts()
    print(f'landmark fit: {n} cells, corr_landmarks={n_landmarks}, '
          f'{fit_s:.3f} s; phases {jm.phase_timings}; mapping '
          f'{ {k: round(v, 3) for k, v in jm._mapping_timings.items()} }; '
          f'epochs {jm.epochs_run} train {jm.fit_seconds:.3f} s; '
          f'launches {counts}', flush=True)
    F = jm.match_result[0]
    # the two landmark distance matrices, then one 8192-row block of
    # cell-to-landmark distances per modality
    k3_min = 2 + 2 * math.ceil(n / 8192)
    if counts['fused_pd_grad_update'] != jm.config.epoch_pd:
        fail(f'K1 launched {counts["fused_pd_grad_update"]} times in the '
             f'landmark fit, expected epoch_pd={jm.config.epoch_pd}')
    if counts['pairwise_euclidean'] < k3_min:
        fail(f'K3 launched {counts["pairwise_euclidean"]} times in the '
             f'landmark fit, expected at least {k3_min}')
    if not (isinstance(F, LowRankF) and not isinstance(F, SparseLandmarkF)
            and F.rank == n_landmarks and F.shape == (n, n)
            and bool(torch.isfinite(F.u).all())
            and bool(torch.isfinite(F.v).all())):
        fail(f'landmark F is {F!r}, not a finite rank-{n_landmarks} '
             'LowRankF')
    if jm.dist is not None:
        fail('the landmark fit built dense distance matrices')
    if not (isinstance(jm.P, str) and jm.P == 'identity'
            and jm.trainer._p_identity and jm.sampling_method == 'diag'):
        fail(f'landmark fit P {jm.P!r}, sampling {jm.sampling_method!r}: '
             "expected the identity sentinel and 'diag'")
    for i, e in enumerate(out):
        if e.shape != (n, 32) or not np.isfinite(e).all():
            fail(f'landmark embedding {i}: shape {e.shape}, finite '
                 f'{np.isfinite(e).all()}')
    # Row-blocked metrics: one K3 launch per block
    ops.reset_launch_counts()
    t = time.perf_counter()
    foscttm = jm.test_closer(out)
    lta = jm.test_LabelTA(out, [labels, labels])
    metrics_s = time.perf_counter() - t
    m_counts = ops.launch_counts()
    bs = max(evaluation._FOSCTTM_BLOCK_ENTRIES // n, 256)
    blocks = 2 * math.ceil(n / bs)
    print(f'landmark metrics: blocked FOSCTTM {foscttm} LTA {lta} '
          f'({metrics_s:.3f} s, {bs}-row blocks); launches {m_counts}',
          flush=True)
    if m_counts['pairwise_euclidean'] != blocks:
        fail(f'the metrics launched K3 {m_counts["pairwise_euclidean"]} '
             f'times, expected {blocks} (one per block)')
    if not (np.isfinite(foscttm) and np.isfinite(lta)
            and foscttm < 0.25 and lta > 0.5):
        fail(f'landmark fit no better than chance: FOSCTTM {foscttm} '
             f'(limit < 0.25), LTA {lta} (limit > 0.5)')
    if not all(np.allclose(a, b, rtol=1e-5, atol=1e-5)
               for a, b in zip(jm.transform(data), out)):
        fail('transform differs from the landmark fit output')
    print('landmark serve: transform == fit output', flush=True)
    return list(jm.trainer.data)


def landmark_layout_phase(torch, data, dev, n_landmarks=2048):
    """The dense and k-sparse factor layouts of one landmark solve (same
    seed, euclidean, 200 iterations) held to each other: float32 summation
    order (an (N, L) x (L, L) GEMM against an 8-term mix per row), within
    1e-4 of the largest entry. Returns both (LowRankF, SparseLandmarkF)."""
    from jamie_tpu_torch.solvers.landmark import landmark_correspondence
    n = data[0].shape[0]
    kw = dict(n_landmarks=n_landmarks, epoch_pd=200, verbose=False,
              distance_mode='euclidean', seed=0, device=dev)
    t = time.perf_counter()
    F_dense = landmark_correspondence(*data, factor_layout='dense', **kw)
    F_sparse = landmark_correspondence(*data, factor_layout='sparse', **kw)
    layout_s = time.perf_counter() - t
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for _ in range(3):
        i0 = torch.randint(0, n, (512,), device=dev, generator=gen)
        i1 = torch.randint(0, n, (512,), device=dev, generator=gen)
        bd = F_dense.gather_batch(i0, i1)
        worst = max(worst, float((bd - F_sparse.gather_batch(i0, i1)).abs()
                                 .max() / bd.abs().max()))
    cd = F_dense.col_sums()
    cs_err = float((cd - F_sparse.col_sums()).abs().max() / cd.abs().max())
    print(f'landmark layouts: {n} cells dense vs sparse (euclidean, '
          f'epoch_pd 200, {layout_s:.3f} s for both): gather_batch 3 x '
          f'512x512 max rel |d| {worst}, col_sums {cs_err} (limit 1e-4)',
          flush=True)
    if not (worst <= 1e-4 and cs_err <= 1e-4):
        fail('the dense and sparse landmark layouts disagree')
    return F_dense, F_sparse


def landmark_reference_phase(dev, n=600, n_landmarks=128):
    """A small landmark solve on `dev` against the same solve on the CPU:
    identical FPS picks; on rows whose 8th and 9th landmark distances
    differ by more than K3's 1e-5 of the norm scale (the same 8 neighbours
    on both), weights V within 1e-4 and U within 1e-3 of its largest entry
    (float32 solver)."""
    from jamie_tpu_torch.solvers import landmark as LM
    rng = np.random.RandomState(0)
    z = rng.randn(n, 8).astype(np.float32)
    xs = [(z @ rng.randn(8, f) + 0.1 * rng.randn(n, f)).astype(np.float32)
          for f in (50, 30)]
    picks = []
    for d in (dev, 'cpu'):
        prng = np.random.RandomState(5)
        picks.append([LM._select_landmarks(a, n_landmarks, 'fps', prng, d)
                      for a in xs])
    if not all(np.array_equal(a, b) for a, b in zip(*picks)):
        fail('FPS picked other landmarks on the card than on the CPU')
    kw = dict(n_landmarks=n_landmarks, k_interp=8, epoch_pd=200,
              verbose=False, distance_mode='euclidean', precision='highest',
              seed=5)
    F_dev = LM.landmark_correspondence(*xs, device=dev, **kw)
    F_cpu = LM.landmark_correspondence(*xs, device='cpu', **kw)

    def resolved(x, lm):
        d2 = ((x[:, None, :].astype(np.float64) - lm[None]) ** 2).sum(-1)
        d2.sort(axis=1)
        scale = 2 * float((x.astype(np.float64) ** 2).sum(1).max())
        return d2[:, 8] - d2[:, 7] > 1e-5 * scale

    ok_x = resolved(xs[0], xs[0][picks[1][0]])
    ok_y = resolved(xs[1], xs[1][picks[1][1]])
    v_err = float(np.abs(F_dev.v.cpu().numpy() - F_cpu.v.numpy())[ok_y].max())
    u_cpu = F_cpu.u.numpy()
    u_err = float(np.abs(F_dev.u.cpu().numpy() - u_cpu)[ok_x].max())
    u_lim = 1e-3 * float(np.abs(u_cpu).max())
    print(f'reference: landmark_correspondence {n} cells L={n_landmarks} '
          f'euclidean epoch_pd 200 card vs CPU: FPS identical; on '
          f'{ok_x.mean():.3f} / {ok_y.mean():.3f} resolved rows max |dV| '
          f'{v_err} (limit 1e-4), max |dU| {u_err} (limit {u_lim})',
          flush=True)
    if not (v_err <= 1e-4 and u_err <= u_lim):
        fail('landmark_correspondence on the card disagrees with the CPU')


def host_csr_from_card(torch, n, f, fill, rows=4096):
    """A host scipy CSR (n, f) made on the card: dense f32 row blocks
    fill(s, e) converted to CSR there and brought back as indices and
    values, so the dense matrix never exists on the host."""
    import warnings

    import scipy.sparse as sp
    indptr, cols, vals, nnz = [np.zeros(1, np.int64)], [], [], 0
    for s in range(0, n, rows):
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', UserWarning)  # "beta state"
            blk = fill(s, min(s + rows, n)).to_sparse_csr()
        indptr.append((blk.crow_indices()[1:] + nnz).cpu().numpy())
        cols.append(blk.col_indices().to(torch.int32).cpu().numpy())
        vals.append(blk.values().cpu().numpy())
        nnz = int(indptr[-1][-1])
    ip = np.concatenate(indptr)
    return sp.csr_matrix((np.concatenate(vals), np.concatenate(cols),
                          ip.astype(np.int32 if nnz < 2 ** 31 else np.int64)),
                         shape=(n, f))


def cutoff_for(torch, gen, block, density):
    """The (1 - density) quantile of a block, from a 2^22-entry sample."""
    flat = block.reshape(-1)
    idx = torch.randint(0, flat.numel(), (1 << 22,), generator=gen,
                        device=flat.device)
    return float(torch.quantile(flat[idx], 1.0 - density))


def atlas_on_card(torch, dev, n, dims=(20000, 40000), density=0.03,
                  seed=0, dense=False):
    """The sparse multiome atlas of examples/atlas_scale.py --sparse-data
    (examples/synth.py:77-128), generated on the card from a seeded
    torch.Generator: a 24-dimensional latent around 12 cluster centres,
    each modality relu(z W + 0.3 noise - cutoff) with the cutoff at the
    first 4096 rows' (1 - density) quantile. Returns host scipy CSR
    matrices (or dense device tensors with dense=True) and the labels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(n, 24, generator=g, device=dev)
    centres = 2.0 * torch.randn(12, 24, generator=g, device=dev)
    assign = torch.randint(0, 12, (n,), generator=g, device=dev)
    z += centres[assign]
    out = []
    for d in dims:
        w = torch.randn(24, d, generator=g, device=dev)

        def fill(s, e):
            xb = z[s:e] @ w
            xb += 0.3 * torch.randn(xb.shape, generator=g, device=dev)
            return xb
        cut = cutoff_for(torch, g, fill(0, min(4096, n)), density)

        def relu_block(s, e):
            return (fill(s, e) - cut).clamp_(min=0.0)
        out.append(relu_block(0, n) if dense
                   else host_csr_from_card(torch, n, d, relu_block))
    return out, assign.cpu().numpy()


def scglue_on_card(torch, dev, n=9190, f_atac=241757, f_rna=28930,
                   density=0.05, latent=8, seed=1, return_labels=False):
    """scGLUE-shaped modalities (bench.py:211-233's shapes, before its
    per-column scaling), generated on the card: an 8-dimensional latent
    around 6 cluster centres; ATAC as 0/1 peaks, (z W + noise) above the
    first 1024 rows' 95% quantile, as a host CSR (about 111M nonzeros);
    RNA as a dense host f32 relu(z W + 0.5 noise). With return_labels,
    each cell's cluster too."""
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(n, latent, generator=g, device=dev)
    centres = torch.randn(6, latent, generator=g, device=dev)
    cluster = torch.randint(0, 6, (n,), generator=g, device=dev)
    z += 3.0 * centres[cluster]
    w = torch.randn(latent, f_atac, generator=g, device=dev)

    def logits(s, e):
        xb = z[s:e] @ w
        xb += torch.randn(xb.shape, generator=g, device=dev)
        return xb
    cut = cutoff_for(torch, g, logits(0, 1024), density)
    atac = host_csr_from_card(torch, n, f_atac,
                              lambda s, e: (logits(s, e) > cut).float(),
                              rows=1024)
    w = torch.randn(latent, f_rna, generator=g, device=dev)
    rna = (z @ w + 0.5 * torch.randn((n, f_rna), generator=g, device=dev)
           ).clamp_(min=0.0).cpu().numpy()
    if return_labels:
        return atac, rna, cluster.cpu().numpy()
    return atac, rna


def library_row(kp, name, case, ms, bytes_, flops, rate, **extra):
    """Print a timed library call (not a kernel of this repository) with
    its bound on a `library` line."""
    bound_ms, bound_by = kp.bound(bytes_, flops, rate)
    print('library ' + json.dumps(dict(
        name=name, case=case, ms=ms[0], call_ms=ms[1], bound_ms=bound_ms,
        bound_by=bound_by, **extra)), flush=True)


def sparse_reference_phase(torch, dev):
    """A. DeviceCSR on the card against the CPU on a 3000 x 5000 CSR at 3%
    nonzero made on the card, on the exact route and on the bf16 route
    (BF16_LINK_ELEMS patched): matmul, matmul on a row range, tmatmul and
    row_sq_sums within f32 summation order (1e-5 of the same product of
    absolute values), rows bit-identical; then the resident bf16 builds on
    the card and on the CPU bit-identical."""
    from unittest import mock

    from jamie_tpu_torch.core import residency as R
    g = torch.Generator(device=dev).manual_seed(11)
    X = host_csr_from_card(torch, 3000, 5000, lambda s, e: torch.where(
        torch.rand((e - s, 5000), generator=g, device=dev) < 0.03,
        torch.randn((e - s, 5000), generator=g, device=dev), 0.0))
    M = torch.randn(5000, 64, generator=g, device=dev).cpu().numpy()
    Q = torch.randn(3000, 16, generator=g, device=dev).cpu().numpy()
    absX = abs(X)
    worst = {}
    for route, limit in (('exact', R.BF16_LINK_ELEMS), ('bf16', 1)):
        with mock.patch.multiple(R, BF16_LINK_ELEMS=limit):
            gd, cd = R.DeviceCSR(X, dev), R.DeviceCSR(X, 'cpu')
            if gd.bf16 != (route == 'bf16'):
                fail(f'DeviceCSR took the wrong rounding on the {route} route')
            for what, got, want, scale in (
                    ('matmul', gd.matmul(M), cd.matmul(M), absX @ abs(M)),
                    ('matmul[700:2300]', gd.matmul(M, 700, 2300),
                     cd.matmul(M, 700, 2300), absX[700:2300] @ abs(M)),
                    ('tmatmul', gd.tmatmul(Q), cd.tmatmul(Q),
                     absX.T @ abs(Q)),
                    ('row_sq_sums', gd.row_sq_sums(), cd.row_sq_sums(),
                     np.asarray(absX.multiply(absX).sum(1)).ravel())):
                r = float((np.abs(got.cpu().numpy() - want.numpy())
                           / (scale + 1e-30)).max())
                worst[f'{route} {what}'] = r
                if not r <= 1e-5:
                    fail(f'DeviceCSR.{what} ({route}) on the card: '
                         f'{r} of sum |x||m| (limit 1e-5)')
            if not torch.equal(gd.rows(100, 600).cpu(), cd.rows(100, 600)):
                fail(f'DeviceCSR.rows ({route}) differs on the card')
    a = R.build_resident_bf16(X, dev).cpu()
    b = R.build_resident_bf16(X, 'cpu')
    if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
        fail('the resident bf16 builds differ between the card and the CPU')
    print(f'sparse reference: 3000x5000 CSR ({X.nnz} nonzeros) card vs CPU, '
          f'worst |d| / sum|x||m| {worst} (limit 1e-5); rows and the '
          'resident bf16 build bit-identical', flush=True)


def wide_phase(torch, kp, dev, **shape):
    """B. The wide modality at the scGLUE shape: a 9190 x 241,757 CSR of
    0/1 peaks (~5% nonzero) and a dense 9190 x 28,930 f32 host matrix.
    Each through dataset_distance_matrix's bf16-resident route (the
    resident Gram timed), through the feature-chunked route with the
    budget lowered (held to the resident result) and on 256 rows to
    float64 on the bf16-rounded data. Both routes' Grams are cuBLAS bf16
    GEMMs whose f32 accumulation inside the tensor cores truncates: up to
    one f32 ulp of the running sum per 16-deep step, so squared distances
    are held to (f / 16) 2^-23 of the norm scale (0/1 data sum exactly).
    Then
    Preprocessor.fit(pca_dim=512) through the resident and, with the
    budget lowered, the column-streamed PCA: the leading 8 components (the
    generator's latent) agree by subspace cosine (limit > 0.99)."""
    from unittest import mock

    from jamie_tpu_torch import preprocess as PP
    from jamie_tpu_torch.core import residency as R
    from jamie_tpu_torch.ops import distances as D
    t = time.perf_counter()
    atac, rna = scglue_on_card(torch, dev, **shape)
    print(f'data: scGLUE-shaped ATAC {atac.shape} ({atac.nnz} nonzeros, '
          f'{atac.nnz / (atac.shape[0] * atac.shape[1]):.4f} dense) and RNA '
          f'{rna.shape} dense, {time.perf_counter() - t:.2f} s', flush=True)
    for name, x in (('ATAC', atac), ('RNA', rna)):
        n, f = x.shape
        R.route_counts.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        d = D.dataset_distance_matrix(x, 'euclidean', device=dev)
        torch.cuda.synchronize()
        resident_s = time.perf_counter() - t
        xdev = R.device_bf16(x, device=dev)           # the cached build
        gram = time_ms(torch, lambda: D._euclidean_resident_bf16(
            xdev, False, True))
        library_row(kp, 'resident_gram', f'{n}x{n}x{f} {name} bf16 sqrt',
                    gram, n * f * 2 + n * n * 4, 2 * n * n * f, kp.bf16)
        sq = D._row_sq_norms(xdev).double()
        scale = 2 * float(sq.max())
        d2 = d.double() ** 2
        # 256 rows against float64 on the bf16-rounded data
        x0 = xdev[:256].double()
        g64 = torch.cat([x0 @ xdev[s:s + 1024].double().T
                         for s in range(0, n, 1024)], dim=1)
        ref64 = (sq[:256, None] + sq[None, :] - 2 * g64).clamp_(min=0)
        ref64.fill_diagonal_(0.0)
        err64 = float((d2[:256] - ref64).abs().max())
        del x0, g64, ref64
        xs = x.tocsc() if name == 'ATAC' else x
        with mock.patch.multiple(R, DEFAULT_BUDGET_BYTES=0):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dc = D.dataset_distance_matrix(xs, 'euclidean', device=dev)
            torch.cuda.synchronize()
            chunked_s = time.perf_counter() - t
        err_c = float((dc.double() ** 2 - d2).abs().max())
        del dc, d2, d
        # PCA: the resident residency is still cached
        t = time.perf_counter()
        pre_r = PP.Preprocessor.fit(x, pca_dim=512, device=dev)
        torch.cuda.synchronize()
        pca_r_s = time.perf_counter() - t
        R.clear_residency_cache()
        del xdev
        torch.cuda.empty_cache()
        with mock.patch.multiple(R, DEFAULT_BUDGET_BYTES=0):
            t = time.perf_counter()
            pre_s = PP.Preprocessor.fit(xs, pca_dim=512, device=dev)
            torch.cuda.synchronize()
            pca_s_s = time.perf_counter() - t
        qa = torch.linalg.qr(pre_r.pca.components_[:8].double().T)[0]
        qb = torch.linalg.qr(pre_s.pca.components_[:8].double().T)[0]
        cos = torch.linalg.svdvals(qa.T @ qb).cpu().numpy()
        routes = dict(R.route_counts)
        print(f'wide {name} {n}x{f}: distances resident {resident_s:.3f} s '
              f'(build + Gram), feature-chunked {chunked_s:.3f} s, max '
              f'|d2 chunked - d2 resident| {err_c}, 256 rows vs float64 '
              f'{err64} (limit {f / 16 * 2.0 ** -23 * scale:.6g}); PCA 512 '
              f'resident '
              f'{pca_r_s:.3f} s, column-streamed {pca_s_s:.3f} s, leading-8 '
              f'subspace cosines min {cos.min():.6f}; routes {routes}',
              flush=True)
        want = {'distance_resident_bf16': 1, 'distance_feature_chunked': 1,
                'pca_resident_bf16': 1, 'pca_streamed': 1}
        if routes != want:
            fail(f'wide {name}: routes {routes}, expected {want}')
        tol = f / 16 * 2.0 ** -23 * scale
        if not (err_c <= tol and err64 <= tol):
            fail(f'wide {name}: the bf16 distance routes disagree')
        if not cos.min() > 0.99:
            fail(f'wide {name}: the PCA routes span other subspaces')
        del pre_r, pre_s, qa, qb
        R.clear_residency_cache()
        torch.cuda.empty_cache()


def atlas_phase(torch, JAMIE, ops, kp, dev, n=100_000, dims=(20000, 40000),
                epochs=10, metric_cells=10_000, n_landmarks=2048, **fit_kw):
    """C. The 100,000-cell sparse multiome atlas fit
    (examples/atlas_scale.py --sparse-data): 20,000 RNA and 40,000 ATAC
    features at 3% nonzero, JAMIE(corr_landmarks=2048, pca_dim=(512, 512),
    batch_size=512, use_early_stop=False), epoch_DNN the only cut. With
    the counts at 0 just before the fit: K1 epoch_pd launches, K3 at least
    2, the JL-sketch FPS and the SpMM weights for both modalities, the RNA
    PCA bf16-resident and the ATAC PCA row-streamed, a dense-layout
    rank-2048 LowRankF, the identity sentinel and 'diag' sampling. Then
    the exact row-blocked FOSCTTM and LTA on a uniform 10,000-cell
    subsample (FOSCTTM < 0.25, LTA > 0.5), transform on the CSR inputs
    against the fit output, modal_predict on a CSR row block, and the
    SpMM's nonzeros per second at the fit's shapes."""
    import resource
    from jamie_tpu_torch.core import residency as R
    from jamie_tpu_torch.ops.lowrank import LowRankF, SparseLandmarkF
    t = time.perf_counter()
    (rna, atac), labels = atlas_on_card(torch, dev, n, dims)
    print(f'data: atlas {n} cells, RNA {rna.shape} {rna.nnz} nonzeros, ATAC '
          f'{atac.shape} {atac.nnz} nonzeros '
          f'({(rna.nnz + atac.nnz) / (n * sum(dims)):.4f} dense), '
          f'{time.perf_counter() - t:.2f} s', flush=True)
    jm = JAMIE(corr_landmarks=n_landmarks, pca_dim=(512, 512), batch_size=512,
               use_early_stop=False, epoch_DNN=epochs, min_epochs=epochs,
               **fit_kw)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    R.route_counts.clear()
    t = time.perf_counter()
    out = jm.fit_transform(dataset=[rna, atac])
    fit_s = time.perf_counter() - t
    counts, routes = ops.launch_counts(), dict(R.route_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f'atlas fit: {n} cells, {fit_s:.3f} s; phases {jm.phase_timings}; '
          f'mapping { {k: round(v, 3) for k, v in jm._mapping_timings.items()} }; '
          f'epochs {jm.epochs_run} train {jm.fit_seconds:.3f} s; launches '
          f'{counts}; routes {routes}; max_memory_allocated {peak_gb:.2f} GB; '
          f'host peak RSS {rss_gb:.2f} GB', flush=True)
    F = jm.match_result[0]
    if counts['fused_pd_grad_update'] != jm.config.epoch_pd:
        fail(f'K1 launched {counts["fused_pd_grad_update"]} times in the '
             f'atlas fit, expected epoch_pd={jm.config.epoch_pd}')
    if counts['pairwise_euclidean'] < 2:
        fail('K3 launched fewer than 2 times in the atlas fit')
    want = {'fps_jl_sketch': 2, 'weights_spmm': 2, 'pca_resident_bf16': 1,
            'pca_row_streamed': 1}
    if any(routes.get(k) != v for k, v in want.items()):
        fail(f'atlas fit routes {routes}, expected {want}')
    if not (isinstance(F, LowRankF) and not isinstance(F, SparseLandmarkF)
            and F.rank == n_landmarks and F.shape == (n, n)):
        fail(f'atlas F is {F!r}, not a dense-layout rank-{n_landmarks} '
             'LowRankF')
    if not (jm.P == 'identity' and jm.sampling_method == 'diag'):
        fail(f'atlas P {jm.P!r}, sampling {jm.sampling_method!r}')
    for i, e in enumerate(out):
        if e.shape != (n, 32) or not np.isfinite(e).all():
            fail(f'atlas embedding {i}: shape {e.shape}')
    ops.reset_launch_counts()
    t = time.perf_counter()
    foscttm = jm.test_closer(out)
    sub = np.random.RandomState(0).choice(n, metric_cells, replace=False)
    lta = jm.test_LabelTA([e[sub] for e in out], [labels[sub]] * 2)
    print(f'atlas metrics: exact FOSCTTM {foscttm} over {n} cells, LTA {lta} '
          f'on {metric_cells} cells ({time.perf_counter() - t:.3f} s); '
          f'launches {ops.launch_counts()}', flush=True)
    if not (foscttm < 0.25 and lta > 0.5):
        fail(f'atlas fit: FOSCTTM {foscttm} (limit < 0.25), LTA {lta} '
             '(limit > 0.5)')
    # Serve on the CSR inputs
    R.route_counts.clear()
    t = time.perf_counter()
    again = jm.transform([rna, atac])
    serve_routes = dict(R.route_counts)
    block = min(4096, n)
    imputed = jm.modal_predict(rna[:block], 0)
    serve_s = time.perf_counter() - t
    rel = [float(np.abs(a - o).max() / np.abs(o).max())
           for a, o in zip(again, out)]
    f_again = jm.test_closer(again)
    print(f'atlas serve: transform on CSR {serve_s:.3f} s, max |transform - '
          f'fit| / max |fit| {rel}, FOSCTTM of transform {f_again}; '
          f'modal_predict on {block} CSR rows finite '
          f'{bool(np.isfinite(imputed).all())}; transform routes '
          f'{serve_routes}', flush=True)
    if serve_routes.get('pca_transform_spmm') != 2:
        fail('transform on the CSR inputs did not take the SpMM projection')
    if not (max(rel) <= TRANSFORM_REL and abs(f_again - foscttm) <= 0.01):
        fail(f'transform on the CSR inputs is off the fit output: {rel} '
             f'(limit {TRANSFORM_REL}), FOSCTTM {f_again} vs {foscttm}')
    if not (imputed.shape == (block, dims[1]) and np.isfinite(imputed).all()):
        fail('modal_predict on a CSR row block is off')
    del jm, out, again, imputed
    R.clear_residency_cache()
    torch.cuda.empty_cache()
    # The SpMM at the fit's shapes: the row-streamed sketch block and its
    # projection (k = 522), a cell-to-landmark weight block (k = 2048)
    dc = R.DeviceCSR(atac, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for case, k, r, trans in (('sketch block', 522, min(65536, n), False),
                              ('projection X^T Q', 522, n, True),
                              ('weights block', 2048, min(8192, n), False)):
        M = torch.randn((n if trans else dims[1], k), generator=g,
                        device=dev)
        fn = ((lambda: dc.tmatmul(M)) if trans
              else (lambda: dc.matmul(M, 0, r)))
        ms = time_ms(torch, fn)
        nnz = int(dc.indptr_np[r])
        out_rows = dims[1] if trans else r
        library_row(kp, 'spmm', f'ATAC {case} {r} rows k={k}', ms,
                    nnz * 8 + (r + 1) * 4 + M.numel() * 4 + out_rows * k * 4,
                    2 * nnz * k, kp.fp32, nnz=nnz,
                    nnz_per_s=nnz / (ms[0] * 1e-3))


# Device metrics of phase G: each is float32 on the card. Angular and rank
# metrics take two f-term float32 reductions (a norm and a dot product),
# each within f 2^-24 of its scale; wminkowski's sum of f squares is within
# f 2^-24 of its value; the boolean metrics' counts are exact in float32
# (TF32 is off), leaving one division.
DEVICE_METRICS = ('cosine', 'correlation', 'spearman', 'pearson',
                  'kulsinski', 'sokalmichener', 'wminkowski')


def metric_reference64(x, mode, rows):
    """The first `rows` rows of a device metric's matrix, in float64 numpy
    on the host."""
    from scipy.stats import rankdata
    x = x.astype(np.float64)
    if mode in ('cosine', 'correlation', 'spearman', 'pearson'):
        if mode == 'spearman':
            x = rankdata(x, axis=1)
        if mode != 'cosine':
            x = x - x.mean(1, keepdims=True)
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        sim = xn[:rows] @ xn.T
        return (np.clip(1.0 - sim, 0.0, 2.0) if mode in ('cosine',
                                                         'correlation')
                else (1.0 - sim) / 2.0)
    if mode == 'wminkowski':
        sq = (x * x).sum(1)
        return np.sqrt(np.maximum(sq[:rows, None] + sq[None, :]
                                  - 2.0 * x[:rows] @ x.T, 0.0))
    b = (x != 0).astype(np.float64)
    n, s = float(x.shape[1]), b.sum(1)
    ctt = b[:rows] @ b.T
    r = s[:rows, None] + s[None, :] - 2.0 * ctt
    if mode == 'kulsinski':
        return (r - ctt + n) / (r + n)
    return np.where(r > 0, 2.0 * r / ((n - r) + 2.0 * r), 0.0)


def metrics_phase(torch, dev, x, rows=128, host_shape=(300, 200)):
    """G. Every device metric on the card on x (the 1047 x 3000 RNA block),
    its first `rows` rows held to a float64 build (tolerances above),
    timed; then every host-fallback metric, and the two sklearn-only ones
    written in torch, on a host_shape slice (haversine on random latitude
    and longitude), which must run with no sklearn loaded."""
    from jamie_tpu_torch.ops import distances as D
    f = x.shape[1]
    xt = torch.as_tensor(x, device=dev)
    for mode in DEVICE_METRICS:
        d = D.dataset_distance_matrix(xt, mode, device=dev)
        got = d[:rows].double().cpu().numpy()
        ref = metric_reference64(x, mode, rows)
        err = float(np.abs(got - ref).max())
        tol = (1e-6 if mode in ('kulsinski', 'sokalmichener') else
               f * 2.0 ** -24 * float(np.abs(ref).max()) if mode == 'wminkowski'
               else 2 * f * 2.0 ** -24)
        ms = time_ms(torch, lambda: D.dataset_distance_matrix(xt, mode,
                                                              device=dev))
        print(f'metric {mode}: {x.shape[0]}x{f} on the card {ms[0]:.4f} ms '
              f'(call {ms[1]:.4f}); first {rows} rows vs float64 max |d| '
              f'{err:.3g} (limit {tol:.3g})', flush=True)
        if not (d.shape == (x.shape[0], x.shape[0]) and err <= tol):
            fail(f'metric {mode} on the card is off the float64 build')
    n, m = host_shape
    xs = np.ascontiguousarray(x[:n, :m])
    latlon = np.random.RandomState(0).uniform(-1.5, 1.5, (n, 2)).astype(
        np.float32)
    for mode in (*D._HOST_FALLBACK_METRICS, 'nan_euclidean', 'haversine'):
        t = time.perf_counter()
        d = D.pairwise_distance(latlon if mode == 'haversine' else xs, mode,
                                device=dev)
        sec = time.perf_counter() - t
        finite = float(torch.isfinite(d).float().mean())
        print(f'metric {mode}: {n}x{2 if mode == "haversine" else m} '
              f'{sec * 1e3:.1f} ms, finite share {finite:.4f}', flush=True)
        if d.shape != (n, n) or d.device.type != dev.type:
            fail(f'host metric {mode} returned {tuple(d.shape)} on {d.device}')
    if any(k == 'sklearn' or k.startswith('sklearn.') for k in sys.modules):
        fail('a metric loaded sklearn')


def tsne_fit_phase(torch, JAMIE, ops, data, foscttm_limit, **kw):
    """D. JAMIE(project_mode='tsne').fit_transform with every default
    (geodesic, epoch_pd 2000, output_dim 32, perplexity 30, tsne_iters
    1000) and the counts at 0 just before it: K1 epoch_pd launches, K3 2 for
    the geodesic base matrices + 2 per t-SNE iteration; the Hungarian pairs
    permutations; matched pairs closer than a random permutation; FOSCTTM
    within `foscttm_limit`. Returns the fitted estimator."""
    n = data[0].shape[0]
    jm = JAMIE(project_mode='tsne', **kw)
    ops.reset_launch_counts()
    t = time.perf_counter()
    out = jm.fit_transform(dataset=data)
    fit_s = time.perf_counter() - t
    counts = ops.launch_counts()
    cfg = jm.config
    foscttm = jm.test_closer(out)
    px, py = jm.pairs_x[0], jm.pairs_y[0]
    d_match = float(np.linalg.norm(out[0][px] - out[1][py], axis=1).mean())
    d_rand = float(np.linalg.norm(
        out[0][px] - out[1][np.random.RandomState(0).permutation(py)],
        axis=1).mean())
    print(f'tsne fit: {n} cells, {fit_s:.3f} s (phases in the table above); '
          f'FOSCTTM {foscttm} (limit {foscttm_limit}); matched-pair distance '
          f'{d_match:.4f} vs random {d_rand:.4f}; pairs on the true cell '
          f'{float(np.mean(px == py)):.4f}', flush=True)
    print('tsne_launches ' + json.dumps(counts), flush=True)
    k3 = 2 + 2 * cfg.tsne_iters
    if counts['fused_pd_grad_update'] != cfg.epoch_pd:
        fail(f'K1 launched {counts["fused_pd_grad_update"]} times in the tsne '
             f'fit, expected epoch_pd={cfg.epoch_pd}')
    if counts['pairwise_euclidean'] != k3:
        fail(f'K3 launched {counts["pairwise_euclidean"]} times in the tsne '
             f'fit, expected {k3}')
    for i, e in enumerate(out):
        if e.shape != (n, cfg.output_dim) or not np.isfinite(e).all():
            fail(f'tsne embedding {i}: shape {e.shape}')
    if not all(np.array_equal(np.sort(p), np.arange(n)) for p in (px, py)):
        fail('the Hungarian pairs are not permutations')
    if not (d_match < d_rand and foscttm <= foscttm_limit):
        fail(f'tsne fit: matched pairs {d_match} vs random {d_rand}, '
             f'FOSCTTM {foscttm} (limit {foscttm_limit})')
    return jm


def tsne_reference_phase(torch, dev, n=600, iters=200,
                         states=(0, 50, 100, 200)):
    """D'. The t-SNE on the card against the CPU on n SNARE-shaped cells:
    joint_probabilities within 1e-5 of the largest entry; project_tsne
    (output_dim 32, identity pairs, the same injected init, the CPU's P)
    for `iters` iterations on both, whose drift is printed (t-SNE amplifies
    float32 rounding: a mere change of summation order moves a 200-step
    trajectory by ~1e-2 of its largest coordinate on the CPU), with the
    two embeddings' FOSCTTM within 0.05; and the step itself, the KL
    gradient (K3 distances) on the CPU trajectory's states at `states`
    iterations, for both exaggerations, within 1e-3 of its largest entry
    (a 3xTF32 model on the CPU: at most 1.1e-4)."""
    from jamie_tpu_torch import evaluation
    from jamie_tpu_torch.ops.distances import pairwise_distance
    from jamie_tpu_torch.probes import snare_like
    from jamie_tpu_torch.solvers import tsne as T
    data, _ = snare_like(n=n)
    P_cpu = [T.joint_probabilities(pairwise_distance(x, device='cpu'), 30,
                                   device='cpu') for x in data]
    P_err = 0.0
    for x, p in zip(data, P_cpu):
        p_dev = T.joint_probabilities(pairwise_distance(x, device='cpu'), 30,
                                      device=dev).cpu()
        P_err = max(P_err, float((p_dev - p).abs().max() / p.abs().max()))
    rng = np.random.RandomState(1)
    init = [(1e-4 * rng.randn(n, 32)).astype(np.float32) for _ in range(2)]
    pairs = np.arange(n)
    t = time.perf_counter()
    traj = {k: T.project_tsne(None, P_cpu, pairs, pairs, output_dim=32,
                              n_iters=k, init=init, device='cpu')
            for k in states if k}
    traj[0] = init
    cpu_s = time.perf_counter() - t
    t = time.perf_counter()
    Y_dev = T.project_tsne(None, P_cpu, pairs, pairs, output_dim=32,
                           n_iters=iters, init=init, device=dev)
    dev_s = time.perf_counter() - t
    Y_cpu = traj[iters]
    drift = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(Y_dev, Y_cpu))
    f_dev = evaluation.test_closer(Y_dev, device=dev)
    f_cpu = evaluation.test_closer(Y_cpu, device='cpu')
    P_dev = [p.to(dev) for p in P_cpu]
    g_err = 0.0
    for k in states:
        for i in range(2):
            y = torch.as_tensor(traj[k][i])
            for exag in (12.0, 1.0):
                g_cpu = T._kl_grad(P_cpu[i], y, exag)
                g_dev = T._kl_grad(P_dev[i], y.to(dev), exag).cpu()
                g_err = max(g_err, float((g_dev - g_cpu).abs().max()
                                         / g_cpu.abs().max()))
    print(f'reference: t-SNE {n} cells x 32: joint_probabilities card vs CPU '
          f'max |dP| / max P {P_err:.3g} (limit 1e-5); project_tsne {iters} '
          f'iterations card {dev_s:.3f} s, CPU {cpu_s:.3f} s for '
          f'{sum(states)} iterations; trajectory drift max |dY| / max |Y| '
          f'{drift:.3g} (not held: see the docstring); FOSCTTM card {f_dev} '
          f'CPU {f_cpu} (limit 0.05 apart); KL gradient on the CPU states at '
          f'{states} max |dg| / max |g| {g_err:.3g} (limit 1e-3)', flush=True)
    if not (P_err <= 1e-5 and g_err <= 1e-3 and abs(f_dev - f_cpu) <= 0.05):
        fail('the t-SNE on the card disagrees with the CPU')


def preclass_phase(torch, JAMIE, ops, data, dev, dim=512, epochs=20):
    """E. JAMIE(model_pca='umap') and then JAMIE(model_pca='tsne') with
    pca_dim=(dim, dim), epoch_DNN=epochs and no early stop; the second
    reuses the first's F (match_result), so one prime-dual solve runs. Each
    modality's embed timed on its own first; with the counts at 0 for each
    fit: K1 epoch_pd for the first and 0 for the second; K3 2 geodesic + 2
    UMAP distance matrices for the first, 2 + 2 x 750 t-SNE iterations for
    the second. Then transform and modal_predict through the kNN
    interpolation, and save_model -> JAMIE().load_model -> identical
    modal_predict."""
    from jamie_tpu_torch.preprocess import NonlinearEmbedding
    match_result = None
    for method, k1, k3 in (('umap', 2000, 4), ('tsne', 0, 2 + 2 * 750)):
        embed_s = []
        for x in data:
            t = time.perf_counter()
            NonlinearEmbedding(dim, method, device=dev).fit_transform(x)
            embed_s.append(round(time.perf_counter() - t, 3))
        jm = JAMIE(model_pca=method, pca_dim=(dim, dim), epoch_DNN=epochs,
                   min_epochs=min(epochs, 10), use_early_stop=False,
                   match_result=match_result)
        ops.reset_launch_counts()
        t = time.perf_counter()
        out = jm.fit_transform(dataset=data)
        fit_s = time.perf_counter() - t
        counts = ops.launch_counts()
        match_result = jm.match_result
        t = time.perf_counter()
        again = jm.transform(data)
        imputed = jm.modal_predict(data[0], 0)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'model.npz')
            jm.save_model(path)
            imputed2 = JAMIE().load_model(path).modal_predict(data[0], 0)
        serve_s = time.perf_counter() - t
        rel = max(float(np.abs(a - o).max() / np.abs(o).max())
                  for a, o in zip(again, out))
        print(f'preclass {method}: embed {embed_s} s per modality; fit '
              f'{fit_s:.3f} s, phases {jm.phase_timings}, mapping '
              f'{ {k: round(v, 3) for k, v in jm._mapping_timings.items()} }; '
              f'launches {counts}; serve {serve_s:.3f} s, max |transform - '
              f'fit| / max |fit| {rel:.3g}', flush=True)
        if (counts['fused_pd_grad_update'] != k1
                or counts['pairwise_euclidean'] != k3):
            fail(f'preclass {method}: launches {counts}, expected K1 {k1}, '
                 f'K3 {k3}')
        if not all(e.shape == (x.shape[0], 32) and np.isfinite(e).all()
                   for e, x in zip(out + again, data + data)):
            fail(f'preclass {method}: embeddings are off')
        if not (imputed.shape == data[1].shape and np.isfinite(imputed).all()
                and np.array_equal(imputed, imputed2)):
            fail(f'preclass {method}: modal_predict is off or differs after '
                 'save/load')


def lowrank_phase(torch, jm):
    """F. corr_method='jamie': com_corr on the fitted estimator's distance
    matrices with its defaults (10,001 steps per phase, top 5 per row)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    F = jm.com_corr(jm.dist)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    ones = F.sum(1)
    print(f'lowrank corr: {tuple(F.shape)} in {sec:.3f} s (2 x 10,001 '
          f'autograd steps); ones per row min {float(ones.min())} max '
          f'{float(ones.max())}', flush=True)
    if not (bool(((F == 0) | (F == 1)).all()) and bool((ones == 5).all())):
        fail('the binarized low-rank F does not have 5 ones in every row')


def tsne_scale_phase(torch, ops, kp, dev, P_joint, iters, label):
    """H. project_tsne alone on the given joint probabilities (identity
    pairs, output_dim 32) with the counts at 0: seconds per iteration, K3
    launches (2 per iteration) and the iteration's bytes bound, the (N, N)
    float32 passes the code makes (2 x tsne.NN_PASSES_PER_KL_GRAD) at the
    card's memory rate."""
    from jamie_tpu_torch.solvers import tsne as T
    n = P_joint[0].shape[0]
    pairs = np.arange(n)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    Y = T.project_tsne(None, P_joint, pairs, pairs, output_dim=32,
                       n_iters=iters, device=dev)
    sec = time.perf_counter() - t
    counts = ops.launch_counts()
    bound_ms = 2 * T.NN_PASSES_PER_KL_GRAD * n * n * 4 / kp.bw * 1e3
    per = sec / iters * 1e3
    print(f'tsne scale {label}: {n} cells x 32, {iters} iterations in '
          f'{sec:.3f} s = {per:.4f} ms per iteration; bytes bound '
          f'{bound_ms:.4f} ms ({2 * T.NN_PASSES_PER_KL_GRAD} passes of '
          f'{n}^2 f32), {bound_ms / per:.3f} of it; launches {counts}',
          flush=True)
    if counts['pairwise_euclidean'] != 2 * iters:
        fail(f'tsne scale {label}: K3 launched {counts["pairwise_euclidean"]}'
             f' times, expected {2 * iters}')
    if not all(np.isfinite(y).all() for y in Y):
        fail(f'tsne scale {label}: non-finite embedding')


def scglue_cells_probabilities(torch, dev, n=9190, f=50, seed=2):
    """Joint probabilities of two 9190 x 50 views generated on the card (an
    8-dimensional latent around 6 centres, each view z W + noise), through
    K3 euclidean distances."""
    from jamie_tpu_torch.ops.distances import pairwise_distance
    from jamie_tpu_torch.solvers import tsne as T
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(n, 8, generator=g, device=dev)
    z += 3.0 * torch.randn(6, 8, generator=g, device=dev)[
        torch.randint(0, 6, (n,), generator=g, device=dev)]
    out = []
    for _ in range(2):
        x = z @ torch.randn(8, f, generator=g, device=dev)
        x += 0.5 * torch.randn(x.shape, generator=g, device=dev)
        out.append(T.joint_probabilities(pairwise_distance(x, device=dev), 30,
                                         device=dev))
    return out


def write_10x_triplet(directory, counts, prefix):
    """Write an integer cells x features matrix as a gzipped 10x v3 mtx
    triplet: matrix.mtx.gz (features x cells), features.tsv.gz and
    barcodes.tsv.gz. gzip level 1: level 9 takes 16x as long on the
    17.8 MB RNA matrix and the format does not depend on it."""
    import scipy.io as sio
    import scipy.sparse as sp
    os.makedirs(directory)
    with gzip.open(os.path.join(directory, 'matrix.mtx.gz'), 'wb',
                   compresslevel=1) as fh:
        sio.mmwrite(fh, sp.coo_matrix(counts.T))
    with gzip.open(os.path.join(directory, 'features.tsv.gz'), 'wt') as fh:
        fh.writelines(f'{prefix}{j}\t{prefix}{j}\tGene Expression\n'
                      for j in range(counts.shape[1]))
    with gzip.open(os.path.join(directory, 'barcodes.tsv.gz'), 'wt') as fh:
        fh.writelines(f'CELL{i}-1\n' for i in range(counts.shape[0]))


def workflow_phase(torch, JAMIE, ops, data, labels, dev, smi_line, epochs=20,
                   pca_dim=512, batch_features=32, shap_rows=16,
                   shap_genes=64, shap_coalitions=256):
    """I. The raw-file workflow (README's path from 10x files): the RNA
    block as integer counts (np.rint of 4x the generator's values) and the
    0/1 ATAC block written as gzipped 10x v3 triplets, read back with
    io.read_10x_mtx (equal to the source exactly), RNA normalized with
    normalize.normalize_log_cpm (within 1e-6 of float64 numpy), both kept
    CSR. Fit W: JAMIE(compute_dtype='bfloat16', pca_dim, epoch_chunk=5,
    snapshots every 10 epochs, a metrics log), epoch_DNN the only cut, the
    counts at 0 just before it: K1 epoch_pd launches, K3 at least 2, one
    metrics record per 5 epochs with jamie_tpu's keys and device memory,
    snapshots epoch_10 and epoch_20. A float32 twin on W's F (no solve):
    its FOSCTTM within 0.05 of W's. A fresh trainer restored from epoch_10
    and fitted to the end: its embeddings bit-equal to W's. Serve: W's
    checkpoint keeps compute_bf16 and modal_predict is identical after the
    reload. Explain, on the twin: occlusion over every RNA gene (three
    held to re-transforming the occluded raw matrix within 2e-5), native
    SHAP on `shap_rows` cells and `shap_genes` genes (efficiency within
    1e-4 of max |f(x) - base|), and test_partial at fractions 0, 0.5, 1 on
    W's F."""
    import scipy.sparse as sp

    from jamie_tpu_torch import io, normalize
    from jamie_tpu_torch.evaluation import (ShapValues, occlusion_impact_device,
                                            shap_explain, test_partial)
    from jamie_tpu_torch.models import CoupledVAE
    from jamie_tpu_torch.train.trainer import JamieTrainer
    secs = {}
    n = data[0].shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        # Files: write, read back, normalize
        t = time.perf_counter()
        counts = [np.rint(4 * data[0]).astype(np.int64),
                  data[1].astype(np.int64)]
        for name, c in zip(('rna', 'atac'), counts):
            write_10x_triplet(os.path.join(tmp, name), c, name.upper())
        secs['write'] = time.perf_counter() - t
        t = time.perf_counter()
        mats = []
        for name, c in zip(('rna', 'atac'), counts):
            X, barcodes, names = io.read_10x_mtx(os.path.join(tmp, name))
            if not (X.format == 'csr' and X.shape == c.shape
                    and (X != sp.csr_matrix(c)).nnz == 0
                    and len(barcodes) == n and len(names) == c.shape[1]
                    and names[1] == f'{name.upper()}1'):
                fail(f'read_10x_mtx({name}) differs from the source')
            mats.append(X)
        secs['read'] = time.perf_counter() - t
        t = time.perf_counter()
        rna64 = normalize.normalize_log_cpm(mats[0])
        secs['normalize'] = time.perf_counter() - t
        c0 = counts[0].astype(np.float64)
        ref = np.log1p(c0 / np.maximum(c0.sum(1, keepdims=True), 1.0) * 1e4)
        norm_err = float(np.abs(rna64.toarray() - ref).max())
        if not (sp.issparse(rna64) and norm_err <= 1e-6):
            fail(f'normalize_log_cpm is off float64 numpy by {norm_err}')
        rna, atac = rna64.astype(np.float32), mats[1].astype(np.float32)
        dataset = [rna, atac]

        # Fit W: bf16 compute, snapshots, the metrics log
        ck, mpath = os.path.join(tmp, 'snapshots'), os.path.join(tmp, 'm.jsonl')
        fit_kw = dict(pca_dim=(pca_dim, pca_dim), epoch_DNN=epochs,
                      min_epochs=min(10, epochs), use_early_stop=False)
        W = JAMIE(compute_dtype='bfloat16', epoch_chunk=5, checkpoint_dir=ck,
                  checkpoint_every=10, metrics_path=mpath, **fit_kw)
        ops.reset_launch_counts()
        t = time.perf_counter()
        out_w = W.fit_transform(dataset=dataset)
        secs['fit_bf16'] = time.perf_counter() - t
        w_counts = ops.launch_counts()
        records = [json.loads(line) for line in open(mpath)]
        snaps = sorted(os.listdir(ck))
        keys = {'epoch_start', 'epoch_end', 'epoch_loss_mean', 'losses',
                'seconds', 'memory'}
        if w_counts['fused_pd_grad_update'] != W.config.epoch_pd:
            fail(f'K1 launched {w_counts["fused_pd_grad_update"]} times in '
                 f'the workflow fit, expected epoch_pd={W.config.epoch_pd}')
        if w_counts['pairwise_euclidean'] < 2:
            fail('K3 launched fewer than 2 times in the workflow fit')
        if not (len(records) == epochs // 5
                and all(set(r) == keys and r['memory'] for r in records)
                and [r['epoch_end'] for r in records]
                == list(range(5, epochs + 1, 5))):
            fail(f'metrics log: {records}')
        if snaps != [f'epoch_{e}' for e in range(10, epochs + 1, 10)]:
            fail(f'snapshots {snaps}')
        for e in out_w:
            if e.shape != (n, 32) or not np.isfinite(e).all():
                fail(f'workflow embedding shape {e.shape}')

        # The float32 twin on W's F
        T = JAMIE(match_result=W.match_result, **fit_kw)
        ops.reset_launch_counts()
        t = time.perf_counter()
        out_t = T.fit_transform(dataset=dataset)
        secs['fit_f32_twin'] = time.perf_counter() - t
        t_counts = ops.launch_counts()
        f_w, f_t = W.test_closer(out_w), T.test_closer(out_t)
        lta_w = W.test_LabelTA(out_w, [labels, labels])
        lta_t = T.test_LabelTA(out_t, [labels, labels])
        if not abs(f_w - f_t) <= 0.05:
            fail(f'bf16 fit FOSCTTM {f_w} vs float32 twin {f_t}')

        # Resume: a fresh trainer from epoch_10, fitted to the end
        def resume():
            tr = JamieTrainer(W.config, CoupledVAE(
                tuple(W.col), W.config.output_dim, dropout=W.config.dropout,
                compute_dtype=torch.bfloat16), W.trainer.data, W.P, W.F,
                device=dev)
            tr.fit(state=tr.restore_fit_state(os.path.join(ck, 'epoch_10')))
            return tr.final_embed()
        t = time.perf_counter()
        emb_r = resume()
        secs['resume'] = time.perf_counter() - t
        resume_diff = max(float(np.abs(a - b).max())
                          for a, b in zip(emb_r, out_w))
        if resume_diff:
            # equal only if every op is deterministic: a second resume from
            # the same snapshot shows whether the card's training step is
            again = max(float(np.abs(a - b).max())
                        for a, b in zip(resume(), emb_r))
            limit = 1e-5 * max(float(np.abs(e).max()) for e in out_w)
            print(f'workflow resume: max |resumed - W| {resume_diff}, two '
                  f'resumes differ by {again} (limit {limit})', flush=True)
            if not (again and resume_diff <= limit):
                fail('the resumed fit differs from the uninterrupted one')

        # Serve: the checkpoint keeps compute_bf16
        t = time.perf_counter()
        path = os.path.join(tmp, 'model.npz')
        W.save_model(path)
        with np.load(path) as z:
            header = json.loads(bytes(z['__header__'].tolist()).decode())
        W2 = JAMIE().load_model(path)
        imputed = W.modal_predict(rna, 0)
        same = np.array_equal(imputed, W2.modal_predict(rna, 0))
        secs['serve'] = time.perf_counter() - t
        if not (header['compute_bf16'] is True
                and W2.model.compute_dtype == torch.bfloat16 and same
                and imputed.shape == atac.shape
                and np.isfinite(imputed).all()):
            fail(f'bf16 serve: header compute_bf16 '
                 f'{header["compute_bf16"]}, identical after reload {same}')

        # Explain, on the float32 twin
        rna_d, atac_d = rna.toarray(), atac.toarray()
        ops.reset_launch_counts()
        t = time.perf_counter()
        base_r, impact, idx = occlusion_impact_device(
            T, rna_d, atac_d, modality=0, batch_features=batch_features)
        secs['occlusion'] = time.perf_counter() - t
        pre_in, pre_out = T.preprocessors
        tc = torch.as_tensor(pre_out.transform(atac_d), device=dev)
        tc = tc - tc.mean(0)
        occl_err = 0.0
        for fid in (0, rna_d.shape[1] // 2, rna_d.shape[1] - 1):
            occ = rna_d.copy()
            occ[:, fid] = occ[:, fid].mean()
            with torch.no_grad():
                pred = T.model.impute(torch.as_tensor(
                    pre_in.transform(occ), device=dev), 0, 1)
            pc = pred - pred.mean(0)
            r = float(((pc * tc).sum(0) / torch.clamp(
                torch.linalg.vector_norm(pc, dim=0)
                * torch.linalg.vector_norm(tc, dim=0), min=1e-12)).mean())
            occl_err = max(occl_err, abs(float(impact[fid]) - (base_r - r)))
        if not (impact.shape == (rna_d.shape[1],) and np.isfinite(impact).all()
                and occl_err <= 2e-5):
            fail(f'occlusion: off the brute force by {occl_err}')
        t = time.perf_counter()
        res = shap_explain(T, rna_d[:shap_rows], modality=0,
                           max_evals=shap_coalitions,
                           features=np.arange(shap_genes))
        secs['shap'] = time.perf_counter() - t
        total = T.modal_predict(rna_d[:shap_rows], 0) - res.base_values
        eff = float(np.abs(res.values.sum(1) - total).max())
        eff_lim = 1e-4 * float(np.abs(total).max())
        if not (isinstance(res, ShapValues) and np.isfinite(res.values).all()
                and res.values.shape == (shap_rows, shap_genes, atac.shape[1])
                and eff <= eff_lim):
            fail(f'SHAP: {type(res).__name__}, efficiency off by {eff} '
                 f'(limit {eff_lim})')
        np.random.seed(0)
        t = time.perf_counter()
        acc, _ = test_partial([rna_d, atac_d], [labels, labels],
                              fraction_range=(0, 0.5, 1), plot=False,
                              match_result=W.match_result, **fit_kw)
        secs['test_partial'] = time.perf_counter() - t
        if not (len(acc['lta']) == len(acc['foscttm']) == 3
                and np.isfinite(acc['lta'] + acc['foscttm']).all()):
            fail(f'test_partial: {acc}')
    print(f'workflow: {smi_line} | files {counts[0].shape}+{counts[1].shape} '
          f'normalize max |d| {norm_err:.3g}; bf16 fit FOSCTTM {f_w} LTA '
          f'{lta_w}, phases {W.phase_timings}, train {W.fit_seconds:.3f} s '
          f'{W.epochs_run} epochs, launches {w_counts}; float32 twin FOSCTTM '
          f'{f_t} LTA {lta_t}, phases {T.phase_timings}, train '
          f'{T.fit_seconds:.3f} s, launches {t_counts}; metrics records '
          f'{len(records)} (last {records[-1]}); snapshots {snaps}; resume '
          f'max |d| {resume_diff}; occlusion {len(idx)} genes, brute-force '
          f'max |d| {occl_err:.3g}, top {int(idx[np.argmax(impact)])}; SHAP '
          f'{res.values.shape} efficiency max |d| {eff:.3g}; test_partial '
          f'{acc}; seconds { {k: round(v, 3) for k, v in secs.items()} }',
          flush=True)


@contextlib.contextmanager
def eager_loops():
    """A context in which every device loop runs its plain version, op by
    op: the steps that `core/graphs.steps_runner` would capture and the
    trainer's epochs (what `_eager=True` and fit(eager=True) select)."""
    from jamie_tpu_torch.core import graphs
    from jamie_tpu_torch.train.trainer import JamieTrainer
    runner, epochs = graphs.steps_runner, JamieTrainer._epoch_runner
    graphs.steps_runner = lambda *a, **k: runner(*a, **{**k, 'eager': True})
    JamieTrainer._epoch_runner = lambda tr, eager=False: epochs(tr, True)
    try:
        yield
    finally:
        graphs.steps_runner, JamieTrainer._epoch_runner = runner, epochs


def mesh_phase(torch, JAMIE, ops, data, dev, integrated, foscttm, fit_s,
               phases, smi_line, kw, n_pd=2048, epoch_pd=2000,
               timing_cells=9190, timing_dim=512,
               timing_epochs=((10, 50), (3, 10))):
    """K. The mesh path at world size 1: a world-size-1 NCCL group started
    through a FileStore (core.mesh.create_mesh), the 1047-cell fit of phase
    4 (same data, same config) through JAMIE(mesh=...) on a ('data',) mesh
    and on a (1, 1) ('data', 'model') mesh, each with the counts at 0: K1
    epoch_pd and K3 >= 2 launches on the sharded path, every prime-dual
    iteration and epoch on the 'mesh_captured' route (CUDA graphs with the
    NCCL collectives inside), FOSCTTM within MESH_FOSCTTM_TOL of the
    unsharded fit's and the embeddings within MESH_EMBED_RTOL /
    MESH_EMBED_ATOL of them; then each fit once more with every loop op by
    op (`eager_loops`), which must give the same embeddings bit for bit.
    Then an n_pd^2 prime-dual solve on the mesh, captured and with
    `_eager=True` (bit-equal), against the unsharded solve. Then the mesh
    trainer's ms per step, captured and eager, at phase P's bench shape
    (the fit's 1047 PCA-512 cells, batch 512, 2 steps an epoch) and its
    scGLUE shape (timing_cells random PCA-512 cells, 17 steps). One
    `mesh:` line, with the routes the phase's loops took. The group is
    destroyed on the way out, so no later phase sees it. Returns the
    epochs and prime-dual steps that the eager twins ran on the 'mesh'
    route."""
    from jamie_tpu_torch.config import JamieConfig
    from jamie_tpu_torch.core import graphs
    from jamie_tpu_torch.core import mesh as cm
    from jamie_tpu_torch.models import CoupledVAE
    from jamie_tpu_torch.ops.distances import pairwise_distance
    from jamie_tpu_torch.solvers.prime_dual import prime_dual
    from jamie_tpu_torch.train import trainer as T
    from jamie_tpu_torch.train.trainer import JamieTrainer
    t_phase = time.perf_counter()
    line = {'unsharded': {'seconds': round(fit_s, 3), 'phases': phases,
                          'foscttm': foscttm}}
    bad = []
    twins = {'epochs': 0, 'pd_steps': 0}

    def routes():
        return (dict(T.epoch_routes),
                {k: v for k, v in graphs.loop_steps.items()
                 if k.startswith('prime_dual/')})

    def delta(before, after):
        return [{k: v - b.get(k, 0) for k, v in a.items()
                 if v != b.get(k, 0)} for b, a in zip(before, after)]
    meshes = {}
    try:
        for name, shape, axes in (('data', (1,), ('data',)),
                                  ('data_model', (1, 1), ('data', 'model'))):
            mesh = meshes[name] = cm.create_mesh(shape, axes)
            runs = {}
            for route in ('captured', 'eager'):
                jm = JAMIE(mesh=mesh, **kw)
                before = routes()
                ops.reset_launch_counts()
                t = time.perf_counter()
                if route == 'captured':
                    emb = jm.fit_transform(dataset=data)
                else:
                    with eager_loops():
                        emb = jm.fit_transform(dataset=data)
                secs = time.perf_counter() - t
                runs[route] = dict(emb=emb, jm=jm, seconds=secs,
                                   counts=ops.launch_counts(),
                                   routes=delta(before, routes()))
            cap, eag = runs['captured'], runs['eager']
            jm, emb, counts = cap['jm'], cap['emb'], cap['counts']
            f = jm.test_closer(emb)
            err = max(float(np.abs(a - b).max())
                      for a, b in zip(emb, integrated))
            close = all(np.allclose(a, b, rtol=MESH_EMBED_RTOL,
                                    atol=MESH_EMBED_ATOL)
                        for a, b in zip(emb, integrated))
            twin = max(float(np.abs(a - b).max())
                       for a, b in zip(emb, eag['emb']))
            epochs, steps = cap['routes']
            e_epochs, e_steps = eag['routes']
            twins['epochs'] += e_epochs.get('mesh', 0)
            twins['pd_steps'] += e_steps.get('prime_dual/mesh', 0)
            line[name] = {'mesh': dict(zip(mesh.mesh_dim_names,
                                           mesh.mesh.shape)),
                          'backend': torch.distributed.get_backend(),
                          'seconds': round(cap['seconds'], 3),
                          'eager_seconds': round(eag['seconds'], 3),
                          'phases': jm.phase_timings,
                          'eager_phases': eag['jm'].phase_timings,
                          'launches': counts, 'foscttm': f,
                          'max_abs_embed_diff': err,
                          'max_abs_eager_twin_diff': twin,
                          'routes': cap['routes'],
                          'eager_routes': eag['routes'],
                          'graphs': jm.trainer.graph_stats}
            if counts['fused_pd_grad_update'] != jm.config.epoch_pd:
                bad.append(f'{name}: K1 launched '
                           f'{counts["fused_pd_grad_update"]} times')
            if counts['pairwise_euclidean'] < 2:
                bad.append(f'{name}: K3 launched fewer than 2 times')
            if not (abs(f - foscttm) <= MESH_FOSCTTM_TOL and close):
                bad.append(f'{name}: FOSCTTM {f} vs {foscttm}, embeddings '
                           f'max |diff| {err}')
            if twin != 0.0:
                bad.append(f'{name}: captured and eager fits differ by '
                           f'{twin}')
            if (epochs != {'mesh_captured': jm.trainer.epochs_run}
                    or steps != {'prime_dual/mesh_captured':
                                 jm.config.epoch_pd}):
                bad.append(f'{name}: the captured fit ran {epochs} epochs '
                           f'and {steps} iterations by route')
            if (e_epochs != {'mesh': eag['jm'].trainer.epochs_run}
                    or e_steps != {'prime_dual/mesh': jm.config.epoch_pd}):
                bad.append(f'{name}: the eager twin ran {e_epochs} epochs '
                           f'and {e_steps} iterations by route')
            del runs, cap, eag
        # The prime-dual solve alone at the landmark solve's size, on the
        # (1, 1) mesh: captured, op by op, and unsharded
        g = torch.Generator(device=dev).manual_seed(5)
        xs = [torch.randn(n_pd, dim, device=dev, generator=g)
              for dim in (64, 48)]
        Kx, Ky = (pairwise_distance(x) for x in xs)
        pd_kw = dict(dx=64, dy=48, epoch_pd=epoch_pd, verbose=False)
        t = time.perf_counter()
        F_plain = prime_dual(Kx, Ky, **pd_kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        solves = {}
        for route in ('captured', 'eager'):
            before = routes()
            ops.reset_launch_counts()
            t = time.perf_counter()
            F_mesh = prime_dual(Kx, Ky, mesh=mesh, _eager=route == 'eager',
                                **pd_kw)
            torch.cuda.synchronize()
            solves[route] = dict(
                F=F_mesh, s=time.perf_counter() - t,
                K1=ops.launch_counts()['fused_pd_grad_update'],
                steps=delta(before, routes())[1],
                stats=dict(graphs.last_stats['prime_dual']))
        F_mesh = solves['captured']['F']
        d_f = float((F_mesh - F_plain).abs().max())
        d_twin = float((F_mesh - solves['eager']['F']).abs().max())
        twins['pd_steps'] += solves['eager']['steps'].get('prime_dual/mesh',
                                                           0)
        limit = MESH_PD_REL * float(F_plain.abs().max())
        k1 = [solves[r]['K1'] for r in ('captured', 'eager')]
        line['prime_dual'] = {
            'shape': [n_pd, n_pd], 'epoch_pd': epoch_pd, 'max_abs_dF': d_f,
            'limit': limit, 'max_abs_eager_twin_dF': d_twin,
            'mesh_s': round(solves['captured']['s'], 3),
            'mesh_eager_s': round(solves['eager']['s'], 3),
            'plain_s': round(plain_s, 3), 'K1': k1,
            'steps': [solves[r]['steps'] for r in ('captured', 'eager')],
            'capture': solves['captured']['stats']}
        if not (d_f <= limit and d_twin == 0.0
                and k1 == [epoch_pd, epoch_pd]
                and solves['captured']['steps']
                == {'prime_dual/mesh_captured': epoch_pd}):
            bad.append(f'prime_dual {n_pd}^2: max |dF| {d_f} (limit '
                       f'{limit}), eager twin {d_twin}, K1 {k1}, steps '
                       f'{line["prime_dual"]["steps"]}')
        del Kx, Ky, xs, F_plain, F_mesh, solves

        # The mesh trainer's steps at phase P's bench and scGLUE shapes, on
        # the ('data',) mesh
        mesh = meshes['data']
        cfg = JamieConfig(epoch_DNN=10 ** 6, min_epochs=2500,
                          use_early_stop=False, log_DNN=10 ** 6)
        X = [x.detach() for x in jm.trainer.data]
        n, dims = int(X[0].shape[0]), tuple(int(x.shape[1]) for x in X)
        timing = {}
        tr = JamieTrainer(cfg, CoupledVAE(dims, 32, matmul_bf16=True), X,
                          np.eye(n, dtype=np.float32),
                          np.zeros((n, n), np.float32), device=dev,
                          mesh=mesh)
        timing[f'bench_{n}'] = step_timing(torch, tr, timing_epochs[0])
        del tr
        m, d = timing_cells, timing_dim
        g = torch.Generator(device=dev).manual_seed(0)
        Xs = [torch.randn(m, d, device=dev, generator=g) for _ in range(2)]
        Fs = torch.rand(m, m, device=dev, generator=g)
        tr = JamieTrainer(cfg, CoupledVAE((d, d), 32, matmul_bf16=True), Xs,
                          'identity', Fs, device=dev, mesh=mesh)
        timing[f'scglue_{m}'] = step_timing(torch, tr, timing_epochs[1])
        del tr, Xs, Fs, X, jm
        torch.cuda.empty_cache()
        line['ms_per_step'] = timing
        for key, t_s in timing.items():
            if not (t_s['captured'].get('graph_nodes_per_step')
                    and t_s['eager']['ms_per_step'] > 0):
                bad.append(f'{key}: the mesh trainer did not time both '
                           f'routes: {t_s}')
    finally:
        cm.destroy_group()
    line['eager_twins'] = twins
    line['phase_s'] = round(time.perf_counter() - t_phase, 3)
    line['card'] = smi_line
    print('mesh: ' + json.dumps(line, default=float), flush=True)
    if bad:
        fail('phase K (the mesh path) failed: ' + '; '.join(bad))
    return twins


def thresholds_phase(torch, JAMIE, ops, dev, smi_line, n=24_000,
                     epoch_pd=50, epoch_dnn=2):
    """L. The card's route thresholds: JAMIE() with no corr_landmarks on
    n SNARE-shaped cells per side (n^2 = 576M entries at 24,000: past the
    520M at which jamie_tpu takes the landmark route) at full width, with
    distance_mode='euclidean' (the host Dijkstra of the geodesic default
    takes minutes at this size), epoch_pd and epoch_DNN cut, the counts at
    0 just before the fit. Fails unless F is a dense (n, n) tensor on the
    card (not a LowRankF), K1 launched epoch_pd times, each modality's
    distances took K3 or, past _FEATURE_CHUNK_THRESHOLD elements (ATAC at
    24,000 x 5000), the bf16-resident Gram, the solver ran with the state
    dtype DENSE_F32_STATE_ENTRIES selects, the device peak stayed under
    the card's memory and both (n, 32) embeddings are finite. One
    `thresholds:` line lists every route global's value."""
    from unittest import mock

    from jamie_tpu_torch import estimator as E
    from jamie_tpu_torch.core import residency as R
    from jamie_tpu_torch.ops import distances as D
    from jamie_tpu_torch.ops.lowrank import LowRankF
    from jamie_tpu_torch.probes import route_thresholds, snare_like
    print(f'phase L: {n} cells per side; cuts: distance_mode=euclidean '
          f'(default geodesic), epoch_pd={epoch_pd} (default 2000), '
          f'epoch_DNN={epoch_dnn} (default 10000, no early stop)',
          flush=True)
    t = time.perf_counter()
    data, labels = snare_like(n=n)
    data_s = time.perf_counter() - t
    jm = JAMIE(distance_mode='euclidean', epoch_pd=epoch_pd,
               epoch_DNN=epoch_dnn, min_epochs=epoch_dnn, use_early_stop=False)
    entries = n * n
    want_state = jm._resolved_state_dtype(entries)
    wide = sum(x.size > D._FEATURE_CHUNK_THRESHOLD for x in data)
    if jm._takes_landmarks(entries):
        fail(f'phase L: {entries} entries take the landmark route at the '
             f'default LANDMARK_AUTO_ENTRIES {E.LANDMARK_AUTO_ENTRIES}')
    solves = []
    real_pd = E.prime_dual

    def timed_pd(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F = real_pd(*a, **k)
        torch.cuda.synchronize()
        solves.append((k['state_dtype'], time.perf_counter() - t0))
        return F
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    R.route_counts.clear()
    ops.reset_launch_counts()
    t = time.perf_counter()
    with mock.patch.object(E, 'prime_dual', timed_pd):
        out = jm.fit_transform(dataset=data)
    fit_s = time.perf_counter() - t
    counts, routes = ops.launch_counts(), dict(R.route_counts)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.mem_get_info()[1]
    F = jm.match_result[0]
    t = time.perf_counter()
    foscttm = jm.test_closer(out)
    metrics_s = time.perf_counter() - t
    line = {'cells': n, 'entries': entries, 'data_s': round(data_s, 3),
            'fit_s': round(fit_s, 3), 'phases': jm.phase_timings,
            'mapping': {k: round(v, 3)
                        for k, v in jm._mapping_timings.items()},
            'solves': solves,
            's_per_iteration': [s / epoch_pd for _, s in solves],
            'launches': counts, 'routes': routes,
            'max_memory_allocated': peak,
            'card_total': total, 'foscttm': foscttm,
            'metrics_s': round(metrics_s, 3), 'card': smi_line}
    print('phase L fit: ' + json.dumps(line, default=float), flush=True)
    print('thresholds: ' + json.dumps(route_thresholds()), flush=True)
    bad = []
    if not (isinstance(F, torch.Tensor) and not isinstance(F, LowRankF)
            and tuple(F.shape) == (n, n) and F.is_cuda
            and bool(torch.isfinite(F).all())):
        bad.append(f'F is {type(F).__name__} {tuple(getattr(F, "shape", ()))}'
                   ', not a finite dense (n, n) tensor on the card')
    if counts['fused_pd_grad_update'] != epoch_pd:
        bad.append(f'K1 launched {counts["fused_pd_grad_update"]} times, '
                   f'expected {epoch_pd}')
    if (counts['pairwise_euclidean'] < 2 - wide
            or routes.get('distance_resident_bf16', 0) != wide):
        bad.append(f'K3 launched {counts["pairwise_euclidean"]} times and '
                   f'routes {routes}: expected K3 for {2 - wide} and the '
                   f'bf16-resident Gram for {wide} modalities')
    if [st for st, _ in solves] != [want_state]:
        bad.append(f'the solver ran with {solves}, expected one solve with '
                   f'state_dtype {want_state}')
    if not peak < total:
        bad.append(f'device peak {peak} not under the card total {total}')
    for i, e in enumerate(out):
        if e.shape != (n, 32) or not np.isfinite(e).all():
            bad.append(f'embedding {i}: shape {e.shape}')
    if not np.isfinite(foscttm):
        bad.append(f'FOSCTTM {foscttm}')
    if bad:
        fail('phase L (the dense fit past 520M entries) failed: '
             + '; '.join(bad))


# bench.py's record keys (the train leg's at :151-168, the pipeline
# leg's at :254-300); the MFU key names the card's bf16 peak where bench.py
# names the TPU's
BENCH_KEYS = {
    'record': {'metric', 'value', 'unit', 'vs_baseline', 'extra'},
    'extra': {'train_achieved_tflops', 'train_mfu_vs_card_bf16_peak',
              'scglue_pipeline_seconds', 'scglue_pipeline_vs_ref_cpu',
              'scglue_pipeline_band_seconds',
              'scglue_pipeline_band_vs_ref_cpu', 'scglue_pipeline_reps',
              'input_variant', 'runs'},
    'run': {'scglue_pipeline_seconds', 'scglue_pipeline_vs_ref_cpu',
            'epochs_run', 'phases', 'upload_mb', 'upload_mb_bf16_equiv',
            'host_read_s', 'host_encode_s'},
}
# examples/time_and_memory.py's record keys (:81-104)
TM_KEYS = {'dataset', 'shapes', 'input_variant', 'total_seconds',
           'reference_cpu_seconds', 'speedup', 'epochs_run', 'phases',
           'upload_mb', 'upload_mb_bf16_equiv', 'host_read_s',
           'host_encode_s'}
# FOSCTTM above this is no integration at all (0.5 is chance)
HARNESS_FOSCTTM_LIMIT = 0.5


def harness_kernels(kp, dev, n, dims):
    """K1 and K3 against their plain versions at a harness fit's shapes:
    the (n, n) f32 solve, each modality's self-sqrt distances where they
    take K3 (n * f at most _FEATURE_CHUNK_THRESHOLD) and the FOSCTTM's
    cross-squared blocks of the 32-dimensional embeddings."""
    torch = kp.torch
    from jamie_tpu_torch import evaluation
    from jamie_tpu_torch.ops import distances as D
    g = kp.gen
    kp.pd_update(n, n, torch.float32)
    for f in dims:
        if n * f <= D._FEATURE_CHUNK_THRESHOLD:
            kp.pairwise(torch.randn(n, f, device=dev, generator=g), None,
                        squared=False)
    rows = min(n, max(evaluation._FOSCTTM_BLOCK_ENTRIES // n, 256))
    kp.pairwise(torch.randn(rows, 32, device=dev, generator=g),
                torch.randn(n, 32, device=dev, generator=g), squared=True)
    torch.cuda.empty_cache()


def harness_fit_checks(tag, jm, integrated, counts, routes, n, dims, states,
                       upload_mb, routes_want=None):
    """The checks every harness fit shares: K1 launched epoch_pd times,
    each modality's distances through K3 or, past
    _FEATURE_CHUNK_THRESHOLD elements, the bf16-resident Gram, one solve
    with the state dtype the thresholds select, the residency's upload 2
    bytes a dense element of the modalities it holds (past
    _FEATURE_CHUNK_THRESHOLD or _STREAM_THRESHOLD), finite (n, 32)
    embeddings and FOSCTTM under HARNESS_FOSCTTM_LIMIT. Returns (FOSCTTM,
    the failures)."""
    from jamie_tpu_torch import preprocess as PP
    from jamie_tpu_torch.ops import distances as D
    bad = []
    wide = sum(n * f > D._FEATURE_CHUNK_THRESHOLD for f in dims)
    shipped = 2 * sum(n * f for f in dims if n * f > min(
        D._FEATURE_CHUNK_THRESHOLD, PP._STREAM_THRESHOLD))
    if round(upload_mb * 1e6) != shipped:
        bad.append(f'{tag}: the residency shipped {upload_mb} MB, expected '
                   f'{shipped / 1e6} (2 bytes a dense element)')
    k1 = counts['fused_pd_grad_update']
    if k1 != jm.config.epoch_pd:
        bad.append(f'{tag}: K1 launched {k1} times, expected '
                   f'{jm.config.epoch_pd}')
    if (counts['pairwise_euclidean'] < 2 - wide
            or routes.get('distance_resident_bf16', 0) != wide):
        bad.append(f'{tag}: K3 launched {counts["pairwise_euclidean"]} '
                   f'times and routes {routes}: expected K3 for {2 - wide} '
                   f'and the bf16-resident Gram for {wide} modalities')
    if routes_want is not None and routes != routes_want:
        bad.append(f'{tag}: routes {routes}, expected {routes_want}')
    want_state = jm._resolved_state_dtype(n * n)
    if states != [want_state]:
        bad.append(f'{tag}: the solver ran with {states}, expected one '
                   f'solve with state_dtype {want_state}')
    for i, e in enumerate(integrated):
        if e.shape != (n, 32) or not np.isfinite(e).all():
            bad.append(f'{tag}: embedding {i} shape {e.shape}')
    foscttm = float(jm.test_closer(integrated))
    if not foscttm < HARNESS_FOSCTTM_LIMIT:
        bad.append(f'{tag}: FOSCTTM {foscttm} not under '
                   f'{HARNESS_FOSCTTM_LIMIT}')
    return foscttm, bad


def solver_states():
    """A patch of estimator.prime_dual that records each solve's state
    dtype, and the list it records into."""
    from unittest import mock

    from jamie_tpu_torch import estimator as E
    states = []
    real_pd = E.prime_dual

    def pd(*a, **k):
        states.append(k['state_dtype'])
        return real_pd(*a, **k)
    return mock.patch.object(E, 'prime_dual', pd), states


def link_evidence(torch, dev, x, chunk_bytes=256 << 20):
    """The host link's share of a dense residency, and what jamie_tpu's
    packed-bit link format would cost on this host. One resident build of
    x, timed: the host read and bf16 cast from transfer_stats, the rest
    the copy to the card. Then the packed-bit encode of jamie_tpu's
    'bits2' path (per-column aminmax, the two equality passes and
    np.packbits) on the first row chunk of the build's size, scaled to
    the matrix."""
    from jamie_tpu_torch.core import residency as R
    R.reset_transfer_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    resident = R.build_resident_bf16(x, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    st = R.transfer_stats()
    del resident
    torch.cuda.empty_cache()
    n, f = x.shape
    rows = max(int(chunk_bytes / (f * 2)), 64)
    chunk = np.ascontiguousarray(x[:rows], np.float32)
    t = time.perf_counter()
    xt = torch.from_numpy(chunk)
    lo, hi = torch.aminmax(xt, dim=0)
    eq_hi = xt == hi
    two_valued = bool(torch.logical_or(eq_hi, xt == lo).all())
    packed = np.packbits(eq_hi.numpy(), axis=1)
    bits_s = (time.perf_counter() - t) * n / rows
    copy_s = build_s - st['read_s'] - st['encode_s']
    return {'build_s': build_s, 'read_s': st['read_s'],
            'encode_s': st['encode_s'], 'copy_s': copy_s,
            'bytes': st['bytes'], 'copy_gb_per_s': st['bytes'] / copy_s / 1e9,
            'two_valued': two_valued, 'bits_encode_s': bits_s,
            'bits_bytes': packed.nbytes * n / rows + 8 * f}


def bench_phase(torch, ops, kp, dev, smi_line, epoch_dnn=20, train_chunk=20,
                shapes=None, train_data=None, pca_dim=512, **overrides):
    """M. The bench twin (jamie_tpu_torch.bench) through its leg functions:
    the train leg with one warm-up and one timed chunk of train_chunk
    epochs, then the pipeline leg once at the scGLUE shapes (generated in
    memory), every option at bench's values but epoch_DNN, with the counts
    and route_counts at 0 just before the fit. Fails unless the record has
    bench.py's keys, K1 ran 2000 times, both modalities took the
    bf16-resident distance and PCA, P took the 'identity' sentinel, the
    solver kept f32 state, F is a dense (n, n) tensor on the card, FOSCTTM
    is under HARNESS_FOSCTTM_LIMIT and the residency shipped 2 bytes per
    dense element. One `bench:` line. Returns the fit's launch counts."""
    from jamie_tpu_torch import bench
    from jamie_tpu_torch.core import residency as R
    from jamie_tpu_torch.ops import distances as D
    from jamie_tpu_torch import preprocess as PP
    shapes = shapes or bench.SCGLUE_SHAPES
    cuts = (f'train leg 1 warm-up + 1 timed chunk of {train_chunk} epochs '
            f'(default 1 + 5 of 200); pipeline epoch_DNN={epoch_dnn} '
            f'(default 10000, early stop), data in memory')
    if overrides:
        cuts += f'; {overrides}'
    print(f'phase M: cuts: {cuts}', flush=True)
    t = time.perf_counter()
    record = bench.train_leg(data=train_data, pca_dim=pca_dim,
                             epoch_chunk=train_chunk, timed_chunks=1,
                             device=dev)
    train_s = time.perf_counter() - t
    t = time.perf_counter()
    data = bench.synth_scglue(cache=False, shapes=shapes)
    data_s = time.perf_counter() - t
    n, dims = shapes[0][0], [s[1] for s in shapes]
    harness_kernels(kp, dev, n, dims)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seen = {}

    def on_fit(jm, integrated):
        seen.update(counts=ops.launch_counts(), routes=dict(R.route_counts),
                    peak=torch.cuda.max_memory_allocated(), jm=jm,
                    integrated=integrated)
    patch, states = solver_states()
    R.route_counts.clear()
    ops.reset_launch_counts()
    with patch:
        extra = bench.scglue_pipeline_noise_controlled(
            reps=1, data=data, device=dev, on_fit=on_fit,
            epoch_DNN=epoch_dnn, pca_dim=(pca_dim, pca_dim), **overrides)
    record['extra'].update(extra)
    jm, counts, routes = seen['jm'], seen['counts'], seen['routes']
    # the predicted routes: the distance Gram and the PCA of every modality
    # past its 100M-element threshold read the bf16 residency
    want_routes = {k: v for k, v in (
        ('distance_resident_bf16',
         sum(n * f > D._FEATURE_CHUNK_THRESHOLD for f in dims)),
        ('pca_resident_bf16',
         sum(n * f > PP._STREAM_THRESHOLD for f in dims))) if v}
    run = extra['runs'][0]
    foscttm, bad = harness_fit_checks('phase M', jm, seen['integrated'],
                                      counts, routes, n, dims, states,
                                      run['upload_mb'], routes_want=want_routes)
    link = link_evidence(torch, dev, data[1])
    F = jm.match_result[0]
    line = {'cells_per_sec': record['value'],
            'train_tflops': record['extra']['train_achieved_tflops'],
            'train_mfu': record['extra']['train_mfu_vs_card_bf16_peak'],
            'train_leg_s': train_s, 'data_s': data_s,
            'pipeline_s': run['scglue_pipeline_seconds'],
            'phases': run['phases'], 'epochs_run': run['epochs_run'],
            'mapping': {k: round(v, 3)
                        for k, v in jm._mapping_timings.items()},
            'upload_mb': run['upload_mb'],
            'upload_mb_bf16_equiv': run['upload_mb_bf16_equiv'],
            'host_read_s': run['host_read_s'],
            'host_encode_s': run['host_encode_s'], 'foscttm': foscttm,
            'launches': counts, 'routes': routes, 'states': states,
            'max_memory_allocated': seen['peak'],
            'distance_mode': jm.config.distance_mode, 'link': link,
            'card': smi_line}
    print('bench: ' + json.dumps(line, default=float), flush=True)
    got = {'record': set(record), 'extra': set(record['extra']),
           'run': set(run)}
    if got != BENCH_KEYS:
        bad.append(f'phase M: record keys {got}, expected {BENCH_KEYS}')
    if not (np.isfinite(record['value']) and record['value'] > 0):
        bad.append(f'phase M: train leg value {record["value"]}')
    if not (isinstance(jm.P, str) and jm.P == 'identity'):
        bad.append(f'phase M: P is {type(jm.P).__name__}, expected the '
                   "'identity' sentinel")
    if not (isinstance(F, torch.Tensor) and F.is_cuda
            and tuple(F.shape) == (n, n)):
        bad.append(f'phase M: F is {type(F).__name__}, not a dense (n, n) '
                   'tensor on the card')
    del seen, jm, data
    torch.cuda.empty_cache()
    if bad:
        fail('phase M (the bench twin) failed: ' + '; '.join(bad))
    return counts


def harness_phase(torch, ops, kp, dev, smi_line, epoch_dnn=20, min_epochs=0,
                  keys=None, shape_of=None):
    """N. The time-and-memory twin (jamie_tpu_torch.time_and_memory): its
    run_config for each config but scGLUE (phase M's), at full width,
    epoch_dnn and min_epochs cut, data in memory, with the counts and
    route_counts at 0 just before each. Each fit holds the checks of
    harness_fit_checks and returns the JAX harness's record keys. One
    `time_and_memory:` line. Returns the summed launch counts.
    shape_of(key) may shrink a config (CPU rehearsal)."""
    from jamie_tpu_torch import time_and_memory as TM
    from jamie_tpu_torch.core import residency as R
    keys = keys or [k for k in TM.CONFIGS if k != 'scglue']
    print(f'phase N: configs {keys}; cuts: epoch_dnn={epoch_dnn} (default '
          f'10000), min_epochs={min_epochs} (default 2500), data in memory',
          flush=True)
    args = {k: TM.config_args(k) for k in keys}
    if shape_of is not None:
        args = {k: (a[0], *shape_of(k), a[3], a[4]) for k, a in args.items()}
    for name, s0, s1, _, _ in args.values():
        harness_kernels(kp, dev, s0[0], (s0[1], s1[1]))
    total, rows, bad = {}, {}, []
    for key, (name, s0, s1, ref, b1) in args.items():
        seen = {}

        def on_fit(jm, integrated, _dataset):
            seen.update(counts=ops.launch_counts(),
                        routes=dict(R.route_counts),
                        peak=torch.cuda.max_memory_allocated(), jm=jm,
                        integrated=integrated)
        patch, states = solver_states()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        R.route_counts.clear()
        ops.reset_launch_counts()
        with patch:
            res = TM.run_config(name, s0, s1, ref, epoch_dnn=epoch_dnn,
                                min_epochs=min_epochs, binarize1=b1,
                                device=dev, cache=False, on_fit=on_fit)
        n, dims = s0[0], (s0[1], s1[1])
        foscttm, why = harness_fit_checks(f'phase N {key}', seen['jm'],
                                          seen['integrated'], seen['counts'],
                                          seen['routes'], n, dims, states,
                                          res['upload_mb'])
        bad += why
        if set(res) != TM_KEYS:
            bad.append(f'phase N {key}: record keys {sorted(res)}')
        for k, v in seen['counts'].items():
            total[k] = total.get(k, 0) + v
        rows[key] = {'seconds': res['total_seconds'],
                     'phases': res['phases'],
                     'epochs_run': res['epochs_run'], 'foscttm': foscttm,
                     'upload_mb': res['upload_mb'],
                     'host_read_s': res['host_read_s'],
                     'host_encode_s': res['host_encode_s'],
                     'launches': seen['counts'], 'routes': seen['routes'],
                     'max_memory_allocated': seen['peak']}
        del seen
    print('time_and_memory: ' + json.dumps({'configs': rows,
                                            'card': smi_line}, default=float),
          flush=True)
    if bad:
        fail('phase N (the time-and-memory twin) failed: ' + '; '.join(bad))
    return total



def examples_phase(torch, ops, kp, dev, smi_line, sample_kw=None,
                   tuning_kw=None, imputation_kw=None, atlas_argv=None,
                   sparse_argv=None):
    """O. The twins of the synthetic-data examples
    (jamie_tpu_torch.examples), each through its main on the card at full
    feature width, with the counts at 0 just before each run: sample (the
    README walkthrough, its own settings), tuning (num_search 2, epoch_DNN
    100), imputation_comparison (epoch_DNN 200, min_epochs 50), atlas_scale
    on 100,000 PCA-space cells ('identity' P 4 epochs, then --sparse-prior
    0.5 2 epochs) and --sparse-data on 20,000 cells x 20,000 / 40,000
    features (3% CSR, epoch_pd 300, 10 epochs, LTA on 10,000 cells). K1
    and K3 first against their plain versions at these fits' shapes. One
    `examples:` line. Returns the summed launch counts. The keyword
    arguments shrink the runs (CPU rehearsal)."""
    import importlib.util
    from jamie_tpu_torch.examples import (atlas_scale, imputation_comparison,
                                          sample, tuning)
    from jamie_tpu_torch.ops.lowrank import LowRankF, SparseLandmarkF
    sample_kw = sample_kw or {}
    tuning_kw = tuning_kw or dict(num_search=2, epoch_DNN=100, min_epochs=50)
    imputation_kw = imputation_kw or dict(epoch_DNN=200, min_epochs=50)
    atlas_argv = atlas_argv or (['--epochs', '4'],
                                ['--sparse-prior', '0.5', '--epochs', '2'])
    sparse_argv = sparse_argv or ['--cells', '20000', '--epoch-pd', '300',
                                  '--epochs', '10', '--metric-cells', '10000']
    print(f'phase O: cuts: tuning {tuning_kw}, imputation_comparison '
          f'{imputation_kw}, atlas_scale {atlas_argv}, --sparse-data '
          f'{sparse_argv} (sample runs its own settings {sample_kw})',
          flush=True)
    # the fits' K1 and K3 shapes (the 2048^2 landmark solve and the
    # 2048-landmark distances are step 3's rows)
    g = kp.gen
    for n in (sample_kw.get('n', 300), tuning_kw.get('n', 200),
              int(0.8 * imputation_kw.get('n', 400))):
        harness_kernels(kp, dev, n, (2000, 1000))
    n_imp = imputation_kw.get('n', 400)
    for f in (1000, 2000):                      # predict_knn, both ways
        kp.pairwise(torch.randn(n_imp, f, device=dev, generator=g),
                    torch.randn(int(0.8 * n_imp), f, device=dev, generator=g),
                    squared=True)
    from jamie_tpu_torch import evaluation
    n_sp = int(sparse_argv[sparse_argv.index('--cells') + 1])
    bs = min(n_sp, max(evaluation._FOSCTTM_BLOCK_ENTRIES // n_sp, 256))
    kp.pairwise(torch.randn(bs, 32, device=dev, generator=g),
                torch.randn(n_sp, 32, device=dev, generator=g), squared=True)
    torch.cuda.empty_cache()

    total, rows, bad = {}, {}, []
    has_mpl = importlib.util.find_spec('matplotlib') is not None
    dev_arg = ['--device', str(dev)]

    def run(name, fn):
        seen = {}
        ops.reset_launch_counts()
        t = time.perf_counter()
        rec = fn(seen)
        sec = time.perf_counter() - t
        counts = ops.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        rows[name] = {'seconds': sec, 'launches': counts,
                      'fit_launches': seen.get('counts'), 'record': rec}
        print(f'phase O {name}: {sec:.3f} s; launches {counts} (fit '
              f'{seen.get("counts")})', flush=True)
        return rec, seen, counts

    def on_fit(seen):
        def hook(jm, integrated, dataset):
            seen.update(counts=ops.launch_counts(), jm=jm, data=dataset)
        return hook

    def k1(tag, counts, want):
        if counts['fused_pd_grad_update'] != want:
            bad.append(f'{tag}: K1 launched {counts["fused_pd_grad_update"]} '
                       f'times, expected {want}')

    def band(tag, key, got, ref):
        if not abs(got - ref) <= EXAMPLES_BAND[key]:
            bad.append(f'{tag}: {key} {got} is not within '
                       f'{EXAMPLES_BAND[key]} of jamie_tpu\'s {ref}')

    with tempfile.TemporaryDirectory() as tmp:
        # sample: the README walkthrough, every setting its own
        rec, seen, _ = run('sample', lambda seen: sample.main(
            out_dir=tmp, device=dev, on_fit=on_fit(seen), **sample_kw))
        jm = seen['jm']
        k1('sample', seen['counts'], jm.config.epoch_pd)
        if seen['counts']['pairwise_euclidean'] < 2:
            bad.append('sample: K3 launched fewer than 2 times in the fit')
        for key, ref in EXAMPLES_REF['sample'].items():
            band('sample', key, rec[key], ref)
        x0 = seen['data'][0]
        from jamie_tpu_torch import JAMIE
        again = JAMIE(device=dev).load_model(rec['model_path'])
        if not np.array_equal(again.modal_predict(x0, 0),
                              jm.modal_predict(x0, 0)):
            bad.append('sample: modal_predict differs after the checkpoint '
                       'reload')
        if (rec['figure'] is not None) != has_mpl:
            bad.append(f'sample: figure {rec["figure"]!r} with matplotlib '
                       f'{"present" if has_mpl else "absent"}')
        del seen, jm, again

        # tuning: every search fit after the first reuses its F (both
        # packages refit with the estimator's match_result)
        rec, seen, counts = run('tuning', lambda seen: tuning.main(
            device=dev, **tuning_kw))
        k1('tuning', counts, tuning_kw.get('epoch_pd', 300))
        if not (rec['best_finite'] and rec['best_weights'] is not None
                and np.isfinite(rec['best_weights']).all()):
            bad.append(f'tuning: best weights {rec["best_weights"]}, finite '
                       f'embeddings {rec["best_finite"]}')

        # imputation_comparison: JAMIE against predict_knn and predict_nn
        rec, seen, counts = run('imputation_comparison',
                                lambda seen: imputation_comparison.main(
                                    out_dir=tmp, device=dev,
                                    on_fit=on_fit(seen), **imputation_kw))
        k1('imputation_comparison', seen['counts'],
           imputation_kw.get('epoch_pd', 500))
        knn = counts['pairwise_euclidean'] - seen['counts'][
            'pairwise_euclidean']
        if knn < 2:
            bad.append(f'imputation_comparison: K3 launched {knn} times '
                       'after the fit, expected >= 2 (predict_knn)')
        for i, (got, ref) in enumerate(zip(
                rec['jamie_r'], EXAMPLES_REF['imputation_comparison'][
                    'jamie_r'])):
            if not got > 0:
                bad.append(f'imputation_comparison: JAMIE r[{i}] {got}')
            band(f'imputation_comparison r[{i}]', 'jamie_r', got, ref)
        if (rec['figure'] is not None) != has_mpl:
            bad.append(f'imputation_comparison: figure {rec["figure"]!r}')
        del seen

    # atlas_scale, the PCA-space trainer: 'identity', then the partial prior
    for argv, sampling in zip(atlas_argv, ('diag', 'hybrid')):
        name = 'atlas_scale ' + ' '.join(argv)
        torch.cuda.reset_peak_memory_stats()
        rec, _, _ = run(name, lambda seen: atlas_scale.main(argv + dev_arg))
        cells = int(argv[argv.index('--cells') + 1]) if '--cells' in argv \
            else 100_000
        if not (rec['sampling'] == sampling and rec['finite']
                and rec['embedding_shapes'] == [[cells, 32]] * 2
                and rec['cell_samples_per_sec'] > 0):
            bad.append(f'{name}: sampling {rec["sampling"]} (expected '
                       f'{sampling}), shapes {rec["embedding_shapes"]}, '
                       f'finite {rec["finite"]}')
        rows[name]['max_memory_allocated'] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    # atlas_scale --sparse-data: raw CSR through JAMIE with a landmark F
    name = 'atlas_scale --sparse-data'
    rec, seen, _ = run(name, lambda seen: atlas_scale.main(
        ['--sparse-data', *sparse_argv, *dev_arg], cache=False,
        on_fit=on_fit(seen)))
    jm, n_lm = seen['jm'], min(2048, n_sp)
    k1(name, seen['counts'], jm.config.epoch_pd)
    F = jm.match_result[0]
    if not (isinstance(F, LowRankF) and not isinstance(F, SparseLandmarkF)
            and F.rank == n_lm and F.shape == (n_sp, n_sp)):
        bad.append(f'{name}: F is {F!r}, not a rank-{n_lm} LowRankF')
    if not (rec['foscttm_exact'] < 0.5 and rec['label_transfer_acc'] > 1 / 12):
        bad.append(f'{name}: FOSCTTM {rec["foscttm_exact"]} (limit < 0.5), '
                   f'LTA {rec["label_transfer_acc"]} (limit > 1/12)')
    if set(rec['transfer']) != {'bytes', 'bf16_equiv_bytes', 'read_s',
                                'encode_s'} or 'generate_seconds' not in rec:
        bad.append(f'{name}: record keys {sorted(rec)}, transfer '
                   f'{sorted(rec["transfer"])}')
    del seen, jm, F
    torch.cuda.empty_cache()
    print('examples: ' + json.dumps({'runs': rows, 'card': smi_line},
                                    default=float), flush=True)
    if bad:
        fail('phase O (the examples) failed: ' + '; '.join(bad))
    return total

def state_diff(torch, a, b):
    """The largest |difference| between two FitStates' tensors (0.0 when
    bit-equal), and whether their scalars agree."""
    worst = 0.0
    for name in ('params', 'mu', 'nu'):
        x, y = getattr(a, name).float(), getattr(b, name).float()
        worst = max(worst, float((x - y).abs().max()))
    for k in a.batch_stats:
        worst = max(worst, float((a.batch_stats[k].float()
                                  - b.batch_stats[k].float()).abs().max()))
    scalars = all(getattr(a, f) == getattr(b, f) for f in (
        'count', 'epoch', 'best_running_loss', 'streak', 'stopped'))
    return worst, scalars and torch.equal(a.rng.cpu(), b.rng.cpu())


def capture_pair(torch, make, tmp, tag):
    """One fit captured and the same fit with eager=True (the plain
    version), each from a new trainer (make()): whether they are bit-equal
    and took their routes, and their numbers. Every P and F form is held
    bit-equal, the atomic scatter of SparseLandmarkF's batch gather
    included: it adds each of a row's distinct landmark weights once into
    a zero row, so no two atomics meet in one cell."""
    runs = {}
    for route in ('captured', 'eager'):
        tr = make()
        path = os.path.join(tmp, f'{tag}_{route}.jsonl')
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = tr.fit(metrics_path=path, eager=route == 'eager')
        torch.cuda.synchronize()
        runs[route] = dict(
            state=state, seconds=time.perf_counter() - t,
            history=tr.loss_history, losses=tr.epoch_losses,
            run=tr.epochs_run, stats=dict(tr.graph_stats),
            records=[{k: v for k, v in json.loads(ln).items()
                      if k not in ('seconds', 'memory')}
                     for ln in open(path)])
        del tr
    cap, eag = runs['captured'], runs['eager']
    diff, scalars = state_diff(torch, cap['state'], eag['state'])
    same = (cap['run'] == eag['run'] and cap['records'] == eag['records']
            and cap['history'] == eag['history']
            and cap['losses'] == eag['losses'] and scalars and diff == 0.0)
    ok = (same and cap['stats'].get('route') == 'captured'
          and eag['stats'].get('route') == 'eager')
    return ok, {'route': cap['stats'].get('route'), 'bit_equal': same,
                'max_state_diff': diff, 'epochs_run': cap['run'],
                'stopped': cap['state'].stopped,
                'captured_s': cap['seconds'], 'eager_s': eag['seconds'],
                'capture': {k: cap['stats'].get(k) for k in (
                    'warmup_s', 'capture_s', 'nodes', 'kernel_nodes',
                    'steps_per_epoch')}}


def device_idle(torch, fn):
    """(idle share, device ops) of one call of fn on the card, from
    torch.profiler's CUDA activity: the share of the span from the first
    device op's start to the last one's end in which no op ran."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, 0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return (1.0 - busy / window if window > 0 else None), len(spans)


def step_timing(torch, tr, epochs):
    """ms per step, cells per second, idle share over one epoch and device
    ops (kernels, copies, memsets) per step, eager and captured, on one
    trainer from its initial state each time; epochs = (eager, captured)
    epochs timed after one warm-up epoch."""
    L, B = tr.len_dataloader, tr.batch_size
    out = {}
    for route, n_ep in zip(('eager', 'captured'), epochs):
        tr._load(tr.init_state())
        t = time.perf_counter()
        runner = tr._epoch_runner(eager=route == 'eager')
        build_s = time.perf_counter() - t
        tr._dispatch(runner, 1).result()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr._dispatch(runner, n_ep).result()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        idle, ops_n = device_idle(torch, lambda: tr._dispatch(runner, 1))
        runner.close()
        out[route] = {'ms_per_step': 1e3 * dt / (n_ep * L),
                      'cells_per_sec': n_ep * L * B / dt,
                      'idle_share': idle, 'device_ops_per_step': ops_n / L,
                      'epochs_timed': n_ep, 'build_s': build_s}
        st = tr.graph_stats
        if st['route'] in ('captured', 'mesh_captured'):
            out[route].update(
                graph_launches_per_step=st['launches_per_epoch'] / L,
                graph_nodes_per_step=st['nodes'] / L,
                kernel_nodes_per_step=st['kernel_nodes'] / L,
                capture_s=st['capture_s'], warmup_s=st['warmup_s'],
                nodes=st['nodes'])
    return {'steps_per_epoch': L, 'batch': B, **out}


def train_capture_phase(torch, dev, smi_line, fit_inputs, landmark_inputs,
                        epochs=30, landmark_epochs=3,
                        timing_cells=(9190, 100_000), timing_dim=512,
                        timing_epochs=((20, 100), (5, 20), (1, 3))):
    """P. The trainer's captured epochs against its eager epoch body: at
    full width on the 1047-cell SNARE-shaped data (PCA-512, F the first
    fit's dense F), each fit captured and with eager=True, from new
    trainers: the default 'diag' fit; batch_step=False; the half-mask
    hybrid prior (a 1-D mask); the 'identity' sentinel with F 'zeros'; a
    sparse prior (SparseRows, half the diagonal) with a top-32 SparseRows
    F; compute_dtype='bfloat16'; an early stop inside a chunk under
    dispatch_lookahead=3; then the 19,000-cell landmark data (PCA-512) with
    its LowRankF and SparseLandmarkF layouts, epoch_DNN cut to
    landmark_epochs. Each pair must agree bit for bit in epochs_run,
    loss_history, epoch_losses, the metrics records and the final
    FitState. Then ms per step, cells per
    second, the device's idle share over one epoch and device ops per step,
    eager and captured, at the bench train leg's shape (1047 cells, batch
    512, 2 steps an epoch, bf16 model matmuls, P = I, F = 0), the scGLUE
    pipeline's (9190 cells, 17 steps, bf16 model matmuls, the identity
    sentinel and a dense F) and the 100,000-cell atlas trainer's (195
    steps, a rank-2048 LowRankF), on random PCA-512-shaped data made on the
    card. One `train_capture:` line."""
    from jamie_tpu_torch.config import JamieConfig
    from jamie_tpu_torch.models import CoupledVAE
    from jamie_tpu_torch.ops.lowrank import LowRankF
    from jamie_tpu_torch.ops.sparse import SparseRows
    from jamie_tpu_torch.train.trainer import JamieTrainer
    t_phase = time.perf_counter()
    X, P, F = fit_inputs
    n = int(X[0].shape[0])
    dims = tuple(int(x.shape[1]) for x in X)
    half = (np.arange(n) % 2 == 0).astype(np.float32)
    F_host = F.cpu().numpy() if isinstance(F, torch.Tensor) else F
    idx = np.flatnonzero(half)
    base = dict(epoch_DNN=epochs, min_epochs=10, use_early_stop=False,
                log_DNN=10 ** 6, epoch_chunk=10)
    fits = {
        'diag': (base, P, F),
        'batch_step_false': ({**base, 'batch_step': False}, P, F),
        'hybrid_mask': (base, half, F),
        'identity_zeros': (base, 'identity', 'zeros'),
        'sparse_rows': (base, SparseRows.from_coo(idx, idx, half[idx],
                                                  (n, n)),
                        SparseRows.top_k(F_host, 32)),
        'bf16': ({**base, 'compute_dtype': 'bfloat16'}, P, F),
        'early_stop_lookahead3': (
            {**base, 'epoch_DNN': 100, 'use_early_stop': True,
             'max_steps_without_increment': 3, 'min_increment': 1e9,
             'dispatch_lookahead': 3}, P, F),
    }
    X19, lr_dense, lr_sparse = landmark_inputs
    n19 = int(X19[0].shape[0])
    dims19 = tuple(int(x.shape[1]) for x in X19)
    lm = dict(base, epoch_DNN=landmark_epochs)
    for tag, Fl in (('lowrank_19k', lr_dense), ('sparse_landmark_19k',
                                                lr_sparse)):
        fits[tag] = (lm, 'identity', Fl)
    results, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for tag, (kw, Pt, Ft) in fits.items():
            cfg = JamieConfig(**kw)
            big = tag.endswith('19k')
            data, d = (X19, dims19) if big else (X, dims)

            def make(cfg=cfg, data=data, d=d, Pt=Pt, Ft=Ft):
                bf16 = cfg.compute_dtype == 'bfloat16'
                model = CoupledVAE(d, cfg.output_dim, dropout=cfg.dropout,
                                   seed=cfg.manual_seed,
                                   compute_dtype=(torch.bfloat16 if bf16
                                                  else torch.float32))
                return JamieTrainer(cfg, model, data, Pt, Ft, device=dev)
            ok, res = capture_pair(torch, make, tmp, tag)
            results[tag] = res
            print(f'phase P {tag}: {json.dumps(res, default=float)}',
                  flush=True)
            if not ok:
                bad.append(f'{tag}: captured and eager disagree ({res})')
    stop = results['early_stop_lookahead3']
    if not (stop['stopped'] and stop['epochs_run'] % 10 != 0):
        bad.append(f'the early stop did not land inside a chunk: {stop}')
    del fits
    torch.cuda.empty_cache()

    # ms per step at three shapes
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = {}
    cfg = JamieConfig(epoch_DNN=10 ** 6, min_epochs=2500,
                      use_early_stop=False, log_DNN=10 ** 6)
    model = CoupledVAE(dims, 32, matmul_bf16=True)
    tr = JamieTrainer(cfg, model, X, np.eye(n, dtype=np.float32),
                      np.zeros((n, n), np.float32), device=dev)
    shapes[f'bench_{n}'] = step_timing(torch, tr, timing_epochs[0])
    del tr
    m, d = timing_cells[0], timing_dim
    Xs = [torch.randn(m, d, device=dev, generator=g) for _ in range(2)]
    Fs = torch.rand(m, m, device=dev, generator=g)
    tr = JamieTrainer(cfg, CoupledVAE((d, d), 32, matmul_bf16=True), Xs,
                      'identity', Fs, device=dev)
    shapes[f'scglue_{m}'] = step_timing(torch, tr, timing_epochs[1])
    del tr, Xs, Fs
    m = timing_cells[1]
    Xa = [torch.randn(m, d, device=dev, generator=g) for _ in range(2)]
    Fa = LowRankF(torch.rand(m, 2048, device=dev, generator=g) / 2048,
                  torch.rand(m, 2048, device=dev, generator=g))
    tr = JamieTrainer(cfg, CoupledVAE((d, d), 32), Xa, 'identity', Fa,
                      device=dev)
    shapes[f'atlas_{m}'] = step_timing(torch, tr, timing_epochs[2])
    del tr, Xa, Fa
    torch.cuda.empty_cache()
    for name, s in shapes.items():
        if not (s['captured']['ms_per_step'] > 0
                and s['eager']['ms_per_step'] > 0):
            bad.append(f'{name}: no step time')
    line = {'fits': results, 'shapes': shapes,
            'train_leg_cells_per_sec': {
                r: shapes[f'bench_{n}'][r]['cells_per_sec']
                for r in ('eager', 'captured')},
            'phase_s': time.perf_counter() - t_phase, 'card': smi_line}
    print('train_capture: ' + json.dumps(line, default=float), flush=True)
    if bad:
        fail('phase P (the captured trainer) failed: ' + '; '.join(bad))


def compare_phase(torch, ops, data, labels, dev, smi_line, pca_dim=512,
                  knn_pca_dim=16, mmdma_iters=2001, unioncom_kw=None,
                  nn_epochs=50, small_n=256, small_steps=200,
                  foscttm_ref=COMPARE_FOSCTTM_REF):
    """J. The analysis and baseline modules at full width, each through
    the entry point a user calls, on the card (device=None).

    compare_methods, one method at a time with the counts at 0 just before
    it: NLMA, MMD-MA (`mmdma_iters`, the quick setting of
    examples/comparison.py; the only cut) and UnionCom (every default unless
    `unioncom_kw`: geodesic, epoch_pd 20000, tsne_iters 3000; K1 exactly
    epoch_pd, K3 at least 2 + 2 tsne_iters) on the raw modalities; LMA and
    CCA on Preprocessor PCA-`pca_dim` views. Every embedding (n, 32) and
    finite; NLMA, LMA and CCA within COMPARE_FOSCTTM_TOL of `foscttm_ref`;
    lma_embed on the raw modalities raises the singular-B ValueError.
    Imputation: predict_knn(RNA, ATAC, k=5), K3 launched, 64 rows against
    float64 neighbours on the host within 1e-5; predict_nn on the PCA
    views for `nn_epochs` epochs, its mean per-feature Pearson r. Analysis:
    the silhouette of the NLMA and UnionCom embeddings per modality, card
    against CPU within 1e-5; knn_dist on the RNA PCA-`knn_pca_dim` view
    (on the PCA-512 view exp(-d^2) underflows in float32 for most
    neighbour pairs, in both packages) connected, symmetric, in (0, 1];
    gw_loss and its gradient on seeded 1047 x 32 embeddings through K3's
    autograd Function against autograd through pairwise_euclidean_plain
    with a sqrt guarded at 0 (value within 1e-5 relative, gradient within
    1e-4 of its largest entry, finite); imputation_feature_scores and
    _sign_test_p; none of them imports matplotlib. Card against CPU:
    _mmdma_opt from injected a1, a2 on the first `small_n` cells for
    `small_steps` steps, bandwidths by mmdma_embed's median heuristic,
    within 1e-4 of the embeddings' largest entry."""
    from scipy.sparse.csgraph import connected_components

    from jamie_tpu_torch import compare, figures, nn_funcs, utils
    from jamie_tpu_torch.core import graphs
    from jamie_tpu_torch.models.baselines import predict_nn
    from jamie_tpu_torch.ops.pairwise import pairwise_euclidean_plain
    from jamie_tpu_torch.preprocess import Preprocessor
    n = data[0].shape[0]
    lab2 = [labels, labels]
    secs = {}

    def clock(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
        return out

    views = clock('pca_views', lambda: [
        Preprocessor.fit(x, pca_dim=pca_dim).transform_fit() for x in data])

    # The five baselines through compare_methods
    unioncom_kw = dict(unioncom_kw or {})
    runs = (('NLMA', data, {}), ('MMD-MA', data, {'n_iters': mmdma_iters}),
            ('UnionCom', data, unioncom_kw), ('LMA', views, {}),
            ('CCA', views, {}))
    results, counts = {}, {}
    for name, inputs, kw in runs:
        ops.reset_launch_counts()
        results[name] = clock(name, lambda: compare.compare_methods(
            inputs, lab2, methods=(name,), method_kwargs={name: kw})[name])
        counts[name] = ops.launch_counts()
    for name, r in results.items():
        if not all(e.shape == (n, 32) and np.isfinite(e).all()
                   for e in r['embeddings']):
            fail(f'{name}: embeddings {[e.shape for e in r["embeddings"]]} '
                 f'or not finite')
    off = {name: abs(results[name]['foscttm'] - ref)
           for name, ref in foscttm_ref.items()}
    epoch_pd = unioncom_kw.get('epoch_pd', 20000)
    k3_min = 2 + 2 * unioncom_kw.get('tsne_iters', 3000)
    uc = counts['UnionCom']
    try:
        compare.lma_embed(data)
        raised = None
    except ValueError as e:
        raised = str(e)
    summary = {name: dict(seconds=round(secs[name], 3),
                          foscttm=r['foscttm'], lta=r['lta'],
                          launches=counts[name])
               for name, r in results.items()}
    print(f'compare: {smi_line} | ' + json.dumps(summary), flush=True)
    mm = graphs.last_stats.get('mmdma', {})
    print(f'compare: MMD-MA {mmdma_iters} iterations, '
          f'{secs["MMD-MA"] / mmdma_iters * 1e3:.4f} ms per iteration '
          f'(36 runs batched, setup, scoring, warm-up and capture included; '
          f'route {mm.get("route")}, warm-up {mm.get("warmup_s")} s, capture '
          f'{mm.get("capture_s")} s, {mm.get("kernel_nodes")} kernel nodes '
          f'an iteration); FOSCTTM off '
          f'jamie_tpu\'s {off} (limit {COMPARE_FOSCTTM_TOL}); UnionCom K1 '
          f'{uc["fused_pd_grad_update"]} (expected {epoch_pd}), K3 '
          f'{uc["pairwise_euclidean"]} (at least {k3_min}); raw LMA raised: '
          f'{raised is not None}', flush=True)
    if not all(v <= COMPARE_FOSCTTM_TOL for v in off.values()):
        fail(f'FOSCTTM off jamie_tpu\'s by {off}')
    if (uc['fused_pd_grad_update'] != epoch_pd
            or uc['pairwise_euclidean'] < k3_min):
        fail(f'UnionCom launches {uc}: K1 {epoch_pd}, K3 >= {k3_min} expected')
    if raised is None or 'exceeds the rank' not in raised:
        fail(f'lma_embed on the raw modalities did not raise the singular-B '
             f'ValueError ({raised})')

    # Imputation baselines
    ops.reset_launch_counts()
    knn = clock('predict_knn', lambda: utils.predict_knn(data[0], data[1],
                                                         k=5))
    knn_k3 = ops.launch_counts()['pairwise_euclidean']
    rows = np.random.RandomState(0).choice(n, 64, replace=False)
    x64 = data[0].astype(np.float64)
    sq = (x64 * x64).sum(1)
    d64 = sq[rows, None] + sq[None] - 2 * x64[rows] @ x64.T
    nearest = np.argsort(d64, axis=1, kind='stable')[:, :5]
    knn_err = float(np.abs(knn[rows] - data[1].astype(np.float64)[nearest]
                           .mean(1)).max())
    nn_pred = clock('predict_nn', lambda: predict_nn(views[0], views[1],
                                                     epochs=nn_epochs))
    nn_r = float(np.nanmean(figures.imputation_feature_scores(
        nn_pred, views[1], 'pearson', rng=np.random.RandomState(0))[0]))
    if not (knn_k3 >= 1 and knn_err <= 1e-5 and np.isfinite(nn_pred).all()
            and np.isfinite(nn_r)):
        fail(f'imputation baselines: predict_knn K3 {knn_k3}, 64-row error '
             f'{knn_err}; predict_nn r {nn_r}')

    # Analysis
    sil_err = 0.0
    for name in ('NLMA', 'UnionCom'):
        for e in results[name]['embeddings']:
            card = clock('silhouette', lambda: figures.silhouette_samples(
                e, labels))
            sil_err = max(sil_err, float(np.abs(
                card - figures.silhouette_samples(e, labels,
                                                  device='cpu')).max()))
    view16 = Preprocessor.fit(data[0], pca_dim=knn_pca_dim).transform_fit()
    graph = clock('knn_dist', lambda: nn_funcs.knn_dist(view16))
    edges = graph[graph > 0]
    knn_ok = (connected_components(graph > 0)[0] == 1
              and np.array_equal(graph, graph.T) and edges.size > 0
              and float(edges.max()) <= 1.0)
    g = torch.Generator(device=dev).manual_seed(5)
    embs = [torch.randn(n, 32, device=dev, generator=g) for _ in range(2)]

    def gw(plain):
        xs = [e.clone().requires_grad_(True) for e in embs]
        if plain:
            ds = []
            for x in xs:
                d2 = pairwise_euclidean_plain(x, squared=True)
                live = d2 > 0
                ds.append(torch.where(
                    live, torch.sqrt(torch.where(live, d2, 1.0)), 0.0))
            loss = torch.sum(torch.square(ds[0] - ds[1]))
        else:
            loss = nn_funcs.gw_loss(xs)
        return float(loss.detach()), torch.autograd.grad(loss, xs)

    ops.reset_launch_counts()
    gw_k, grad_k = clock('gw_loss', lambda: gw(False))
    gw_k3 = ops.launch_counts()['pairwise_euclidean']
    gw_p, grad_p = gw(True)
    gw_rel = abs(gw_k - gw_p) / abs(gw_p)
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(grad_k, grad_p))
    grad_finite = all(bool(torch.isfinite(a).all()) for a in grad_k)
    auroc, _ = figures.imputation_feature_scores(
        knn, data[1], 'auroc', rng=np.random.RandomState(0))
    ok = auroc[np.isfinite(auroc)]
    sign_p = figures._sign_test_p(int((ok > 0.5).sum()), int(ok.size))
    plots_loaded = sorted(m for m in ('matplotlib', 'seaborn', 'pandas')
                          if m in sys.modules)

    # MMD-MA card against CPU on small_n cells, injected inits
    rng = np.random.RandomState(1)
    Ks = []
    for x in data:
        x = x[:small_n] / np.maximum(np.linalg.norm(
            x[:small_n], axis=1, keepdims=True), 1e-12)
        Ks.append(torch.as_tensor(x @ x.T))
    a = [torch.as_tensor(rng.rand(4, small_n, 32).astype(np.float32) * 1e-2)
         for _ in Ks]
    E0 = torch.cat([Ks[0] @ a[0][0], Ks[1] @ a[1][0]]).numpy()
    d2 = ((E0[:, None] - E0[None]) ** 2).sum(-1)
    med = float(np.sqrt(np.median(d2[d2 > 0])))
    hyper = [torch.tensor(v, dtype=torch.float32) for v in (
        [.25 * med, med, 4 * med, med], [1e-2, 1e-2, 1e-3, 1e-3],
        [1e-3, 1e-4, 1e-3, 1e-4])]
    outs = []
    for where in (dev, torch.device('cpu')):
        E1, E2, _ = compare._mmdma_opt(*(t.to(where) for t in Ks + a + hyper),
                                       32, small_steps)
        outs.append((E1.cpu(), E2.cpu()))
    mmd_err = max(float((c - w).abs().max() / w.abs().max())
                  for c, w in zip(*outs))

    print(f'analysis: predict_knn k=5 K3 {knn_k3}, 64 rows vs float64 max '
          f'|d| {knn_err:.3g} (limit 1e-5); predict_nn {nn_epochs} epochs '
          f'mean per-feature r {nn_r:.4f}; silhouette card vs CPU max |d| '
          f'{sil_err:.3g} (limit 1e-5); knn_dist on the RNA PCA-{knn_pca_dim} '
          f'view: {int((graph > 0).sum())} entries in '
          f'[{float(edges.min()) if edges.size else None:.3g}, '
          f'{float(edges.max()) if edges.size else None:.3g}], connected and '
          f'symmetric {knn_ok}; gw_loss K3 {gw_k3}, value {gw_k:.6g} vs plain '
          f'{gw_p:.6g} (rel {gw_rel:.3g}, limit 1e-5), gradient max |d| / max '
          f'{grad_err:.3g} (limit 1e-4), finite {grad_finite}; AUROC sign test '
          f'p {sign_p:.3g}; plotting modules loaded {plots_loaded}; MMD-MA '
          f'{small_n} cells x {small_steps} steps card vs CPU max |dE| / max '
          f'{mmd_err:.3g} (limit 1e-4); seconds '
          f'{ {k: round(v, 3) for k, v in secs.items()} }', flush=True)
    if not (sil_err <= 1e-5 and knn_ok and gw_k3 == 2 and gw_rel <= 1e-5
            and grad_err <= 1e-4 and grad_finite and 0 <= sign_p <= 1
            and not plots_loaded and mmd_err <= 1e-4):
        fail('phase J analysis checks failed (see the analysis: line)')


# The real-data examples' files (phase R): synthetic cells in the formats
# of the scGEM, scMNC motor and scMNC visual datasets
FAMILIES = ('Sst Chodl', 'Pvalb Reln', 'L5 IT', 'Vip Sncg')


def synth_cells(rng, n, dims, counts=(False, False), latent=8, noise=0.3):
    """n cells in two modalities of dims features from one latent: four
    cell types of unequal shares (40/30/20/10 %), each a cluster of spread
    1 around its centre; a modality is z W / sqrt(latent) plus normal
    noise of std `noise`, or (counts) Poisson counts around a per-cell
    depth times its exponent. Returns ([x1, x2] float64, type index per
    cell)."""
    labels = rng.choice(4, n, p=(0.4, 0.3, 0.2, 0.1))
    z = 3.0 * rng.randn(4, latent)[labels] + rng.randn(n, latent)
    out = []
    for f, is_count in zip(dims, counts):
        x = z @ rng.randn(latent, f) / np.sqrt(latent)
        if is_count:
            depth = rng.uniform(0.5, 2.0, (n, 1))
            x = rng.poisson(depth * np.exp(np.clip(0.5 * x, -4, 4)))
            out.append(x.astype(np.float64))
        else:
            out.append(x + noise * rng.randn(n, f))
    return out, labels


def write_scgem(directory, rng, n=177, dims=(230, 27), noise=4.0):
    """scGEM's four text files: GeneExpression.txt and DNAmethylation.txt
    (cells x features) and type1.txt / type2.txt (an integer type a
    cell). With 230 genes on 177 cells, LMA's and CCA's B = Z^T D Z is
    singular but for its 1e-6 ridge, and their float32 Cholesky succeeds
    only where the z-scored spectrum is flat: `noise` 4 flattens it (the
    latent's 8 directions carry 5/13 of each gene's variance); at 0.3 the
    Cholesky fails in both packages (jamie_tpu returns NaN, the port
    raises)."""
    (x1, x2), labels = synth_cells(rng, n, dims, noise=noise)
    np.savetxt(os.path.join(directory, 'GeneExpression.txt'), x1, '%.6g')
    np.savetxt(os.path.join(directory, 'DNAmethylation.txt'), x2, '%.6g')
    for name in ('type1.txt', 'type2.txt'):
        np.savetxt(os.path.join(directory, name), labels + 1, '%d')


def _xdr(code, items, attr=b''):
    """An R vector in XDR: its header (type code, 'has attributes' bit),
    length, items (bytes) and attribute pairlist."""
    return (struct.pack('>ii', code | (0x200 if attr else 0), len(items))
            + b''.join(items) + attr)


def _xdr_str(strs, attr=b''):
    return _xdr(16, [struct.pack('>ii', 9 | 1 << 12, len(s.encode()))
                     + s.encode() for s in strs], attr)


def _xdr_real(vals, attr=b'', code=14, dtype='>f8'):
    """A real (or, with code 13 and '>i4', an integer) R vector."""
    vals = np.asarray(vals, dtype)
    return struct.pack('>ii', code | (0x200 if attr else 0), vals.size) \
        + vals.tobytes() + attr


def _xdr_pairlist(items):
    """A tagged pairlist of (name, encoded value)."""
    return b''.join(struct.pack('>ii', 2 | 0x400, 1)
                    + struct.pack('>ii', 9 | 1 << 12, len(k.encode()))
                    + k.encode() + v for k, v in items) \
        + struct.pack('>i', 254)


def _xdr_frame(columns, row_names):
    return _xdr(19, list(columns.values()), _xdr_pairlist([
        ('names', _xdr_str(list(columns))),
        ('class', _xdr_str(['data.frame'])),
        ('row.names', _xdr_str(row_names))]))


def write_motor_rda(directory, rng, n=1208, dims=(1286, 29)):
    """motor_data_filtered.rda as the motor example reads it: gdata (raw
    counts, genes x cells, with dimnames), edata (a data.frame of the
    e-features with the cells as row names, a few values NA) and meta
    ('Cell', 'RNA family', rows in another order), in a gzipped RDX3
    stream."""
    (x1, x2), labels = synth_cells(rng, n, dims, counts=(True, False))
    x2[rng.rand(*x2.shape) < 0.002] = np.nan
    cells = [f'cell{i}' for i in range(n)]
    dim = _xdr_real([dims[0], n], code=13, dtype='>i4')
    dimnames = _xdr(19, [_xdr_str([f'gene{j}' for j in range(dims[0])]),
                         _xdr_str(cells)])
    gdata = _xdr_real(x1.T.ravel(order='F'),
                      _xdr_pairlist([('dim', dim), ('dimnames', dimnames)]))
    edata = _xdr_frame({f'ef{j}': _xdr_real(x2[:, j])
                        for j in range(dims[1])}, cells)
    order = rng.permutation(n)
    meta = _xdr_frame({'Cell': _xdr_str([cells[i] for i in order]),
                       'RNA family': _xdr_str([FAMILIES[labels[i]]
                                               for i in order])},
                      [str(i + 1) for i in range(n)])
    head = b'RDX3\nX\n' + struct.pack('>iiii', 3, 0x30400, 0x30000, 5) \
        + b'UTF-8'
    body = _xdr_pairlist([('gdata', gdata), ('edata', edata),
                          ('meta', meta)])
    with gzip.open(os.path.join(directory, 'motor_data_filtered.rda'), 'wb',
                   compresslevel=1) as fh:
        fh.write(head + body)


def write_visual_csv(directory, rng, n=3654, dims=(1302, 39)):
    """The visual example's three CSV files: geneExp_filtered.csv (a
    gene-name column, then one column of counts a sample),
    efeature_filtered.csv (the sample, two other columns, then the
    e-features, a few empty) and the metadata (transcriptomics_sample_id
    and t_type among other columns, rows in another order)."""
    (x1, x2), labels = synth_cells(rng, n, dims, counts=(True, False))
    samples = [f'SM-{i:05d}_S{i % 97}' for i in range(n)]
    with open(os.path.join(directory, 'geneExp_filtered.csv'), 'w',
              newline='') as fh:
        w = csv.writer(fh)
        w.writerow([''] + samples)
        for j in range(dims[0]):
            w.writerow([f'gene{j}'] + x1[:, j].astype(np.int64).tolist())
    blank = rng.rand(*x2.shape) < 0.002
    with open(os.path.join(directory, 'efeature_filtered.csv'), 'w',
              newline='') as fh:
        w = csv.writer(fh)
        w.writerow(['sample', 'cell_id', 'layer']
                   + [f'ef{j}' for j in range(dims[1])])
        for i in range(n):
            w.writerow([samples[i], i, 'L23'] + [
                '' if blank[i, j] else f'{x2[i, j]:.6g}'
                for j in range(dims[1])])
    with open(os.path.join(directory,
                           '20200711_patchseq_metadata_mouse.csv'), 'w',
              newline='') as fh:
        w = csv.writer(fh)
        w.writerow(['project', 'transcriptomics_sample_id', 't_type',
                    'cell_specimen_id'])
        for i in rng.permutation(n):
            w.writerow(['mIVSCC-MET', samples[i], FAMILIES[labels[i]], i])


def solver_capture_phase(torch, ops, dev, smi_line, fps_x, data,
                         pd_sizes=(300, 1047, 2048, 3654, 9190),
                         pd_iters=110, log_pd=50, delay=50,
                         fps_landmarks=2048, tsne_cells=(1047, 9190),
                         tsne_iters=(200, 100), lowrank_cells=1047,
                         lowrank_epochs=2001, umap_k=15,
                         layout_cells=((1047, 100), (9190, 50)),
                         layout_dim=512, mmdma_iters=200):
    """Q. The solver loops that jamie_tpu compiles as fori_loops, each
    replayed as a captured CUDA graph, against the same step run op by op
    on the card (the loops' private eager argument), with the counts and
    the loop steps by route at 0 before each run:

    - prime-dual at each of pd_sizes (distance-shaped operands), float32
      and bfloat16 state, the fit's 'default' precision, `delay` > 0 and
      pd_iters iterations in chunks of log_pd (pd_iters is not a multiple
      of it): F bit for bit, the printed lines identical, K1 pd_iters
      times on both routes;
    - FPS on fps_x (the 19,000-cell landmark fit's PCA-512 scores),
      fps_landmarks picks: the same indices;
    - t-SNE at each of tsne_cells (joint probabilities of two views made
      on the card): the bisection of `_calibrate_beta`, `_tsne_optimize`
      (output_dim 32, K3 twice an iteration) and `_tsne_single`, bit for
      bit;
    - low-rank on lowrank_cells distance-shaped operands, both phases at
      lowrank_epochs steps: the factors of each phase and the binarized
      output bit for bit;
    - UMAP's sigma bisection (64 steps) on the kNN distances (k = umap_k)
      of data[0], the 1047-cell first modality: rho and sigma bit for bit;
    - UMAP's layout at each (cells, epochs) of layout_cells, layout_dim
      wide (phase E's preclass width), neg_rate 5, the fuzzy graph of
      data[0] at 1047 cells and of 50-dimensional normal points at 9190:
      the layout bit for bit (the partners drawn from one seed each route);
    - MMD-MA's batched optimizer through mmdma_embed on `data` with its
      default grid (36 runs, output_dim 32), mmdma_iters iterations: every
      run's embeddings and MMD and the selected pair bit for bit (the host
      setup and selection inside the timed span).

    ms per step on each route (a captured run's warm-up step and capture
    left out), the capture and warm-up seconds, kernel nodes per step,
    graph launches per step, the replays, the device peak. One
    `solver_capture:` line. Returns the kernel launches of the captured
    runs, by kernel."""
    import importlib
    import io
    from unittest import mock

    from jamie_tpu_torch import compare
    from jamie_tpu_torch.core import graphs
    from jamie_tpu_torch.probes import distance_operand
    from jamie_tpu_torch.solvers import landmark as LM
    from jamie_tpu_torch.solvers import lowrank as LR
    from jamie_tpu_torch.solvers import tsne as TS
    from jamie_tpu_torch.solvers import umap as U
    pdm = importlib.import_module('jamie_tpu_torch.solvers.prime_dual')
    records, bad, captured_counts = [], [], {}

    def run(case, loops, steps, fn, eager, want=None):
        """fn() on one route, timed, with the counts at 0; the output and
        the run's record (ms per step over the replays when captured)."""
        ops.reset_launch_counts()
        graphs.loop_steps.clear()
        for loop in loops:
            graphs.last_stats.pop(loop, None)
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = ops.launch_counts()
        stats = [dict(graphs.last_stats.get(loop, {})) for loop in loops]
        route = 'eager' if eager else 'captured'
        extra = sum(st.get('warmup_s', 0) + st.get('capture_s', 0)
                    for st in stats)
        timed = steps - (0 if eager else len(loops))
        rec = {'case': case, 'route': route, 'steps': steps,
               'seconds': round(sec, 6),
               'ms_per_step': (sec - extra) / max(timed, 1) * 1e3,
               'launches': {k: v for k, v in counts.items() if v},
               'loop_steps': dict(graphs.loop_steps),
               'peak_gib': peak / 2 ** 30}
        if not eager:
            rec.update(
                warmup_s=sum(st.get('warmup_s', 0) for st in stats),
                capture_s=sum(st.get('capture_s', 0) for st in stats),
                kernel_nodes_per_step=[st.get('kernel_nodes')
                                       for st in stats],
                nodes_per_step=[st.get('nodes') for st in stats],
                graph_launches_per_step=(sum(st.get('replays', 0)
                                             for st in stats) / steps),
                replays=sum(st.get('replays', 0) for st in stats))
            for k, v in counts.items():
                captured_counts[k] = captured_counts.get(k, 0) + v
        want_steps = {f'{loop}/{route}': s for loop, s in loops.items()}
        if dict(graphs.loop_steps) != want_steps:
            bad.append(f'{case} {route}: loop steps {dict(graphs.loop_steps)},'
                       f' expected {want_steps}')
        for k, v in (want or {}).items():
            if counts[k] != v:
                bad.append(f'{case} {route}: {k} launched {counts[k]} times, '
                           f'expected {v}')
        return out, buf.getvalue().splitlines(), rec

    def pair(case, loops, steps, fn, want=None):
        """Both routes of one case; holds the outputs (a tensor or a
        sequence of them) bit for bit and records both."""
        outs = []
        for eager in (False, True):
            out, lines, rec = run(case, loops, steps,
                                  lambda: fn(eager), eager, want)
            outs.append((out, lines))
            records.append(rec)
        (a, la), (b, lb) = outs
        a = [a] if isinstance(a, torch.Tensor) else list(a)
        b = [b] if isinstance(b, torch.Tensor) else list(b)
        diff = max(float((x.float() - y.float()).abs().max())
                   if x.numel() else 0.0 for x, y in zip(a, b))
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        records[-2]['bit_equal'] = records[-1]['bit_equal'] = equal
        records[-2]['max_abs_diff'] = records[-1]['max_abs_diff'] = diff
        if not equal:
            bad.append(f'{case}: captured and eager differ by {diff}')
        if la != lb:
            bad.append(f'{case}: the printed lines differ: {la} vs {lb}')
        return outs[0][0]

    for n in pd_sizes:
        Kx, Ky = distance_operand(n, 0, dev), distance_operand(n, 1, dev)
        for state_dtype in ('float32', 'bfloat16'):
            pair(f'prime_dual {n}x{n} state={state_dtype} delay={delay} '
                 f'{pd_iters} iterations log_pd={log_pd}',
                 {'prime_dual': pd_iters}, pd_iters,
                 lambda eager: pdm.prime_dual(
                     Kx, Ky, 32, 32, epoch_pd=pd_iters, log_pd=log_pd,
                     delay=delay, state_dtype=state_dtype, device=dev,
                     _eager=eager),
                 {'fused_pd_grad_update': pd_iters})
        del Kx, Ky
        torch.cuda.empty_cache()

    m = int(fps_x.shape[0])
    pair(f'fps {m}x{int(fps_x.shape[1])} L={fps_landmarks}',
         {'fps': fps_landmarks - 1}, fps_landmarks - 1,
         lambda eager: LM._fps_indices_device(fps_x, 0, fps_landmarks,
                                              eager=eager))

    for n, iters in zip(tsne_cells, tsne_iters):
        P = scglue_cells_probabilities(torch, dev, n=n)
        g = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn(n, 50, generator=g, device=dev)
        D = ops.pairwise_euclidean(x, None, squared=True)
        pair(f'tsne_beta {n} cells, 50 bisection steps', {'tsne_beta': 50},
             50, lambda eager: TS._calibrate_beta(D, 30.0, eager=eager))
        Y = [1e-4 * torch.randn(n, 32, generator=g, device=dev)
             for _ in range(2)]
        pairs = np.arange(n)
        pair(f'tsne {n} cells x 32, {iters} iterations', {'tsne': iters},
             iters, lambda eager: TS._tsne_optimize(
                 P[0], P[1], Y[0], Y[1], pairs, pairs, 10.0, iters,
                 eager=eager),
             {'pairwise_euclidean': 2 * iters})
        pair(f'tsne_single {n} cells x 32, {iters} iterations',
             {'tsne_single': iters}, iters,
             lambda eager: TS._tsne_single(P[0], Y[0], iters, eager=eager),
             {'pairwise_euclidean': iters})
        del P, D, x, Y
        torch.cuda.empty_cache()

    Kx = distance_operand(lowrank_cells, 0, dev).cpu().numpy()
    Ky = distance_operand(lowrank_cells, 1, dev).cpu().numpy()
    real_optimize = LR._optimize

    def lowrank(eager):
        factors = []

        def optimize(name, loss_fn, params, *a, **k):
            real_optimize(name, loss_fn, params, *a, **k)
            factors.extend(p.detach().clone() for p in params)
        with mock.patch.object(LR, '_optimize', optimize):
            out = LR.lowrank_corr(Kx, Ky, epochs=lowrank_epochs, device=dev,
                                  _eager=eager)
        return [out] + factors
    pair(f'lowrank {lowrank_cells} cells, 2 x {lowrank_epochs} steps',
         {'lowrank_cluster': lowrank_epochs, 'lowrank_cast': lowrank_epochs},
         2 * lowrank_epochs, lowrank)
    del Kx, Ky

    def fuzzy(x):
        """W of umap_embed on the rows of x, and their kNN distances."""
        d = ops.pairwise_euclidean(x, None, squared=False)
        knn = -torch.topk(-d.fill_diagonal_(math.inf), umap_k, dim=1)[0]
        return U._fuzzy_graph(d, umap_k), knn
    x0 = torch.as_tensor(np.asarray(data[0], np.float32), device=dev)
    n0 = int(x0.shape[0])
    W0, knn = fuzzy(x0)
    pair(f'umap_sigma {n0} cells k={umap_k}, 64 bisection steps',
         {'umap_sigma': 64}, 64,
         lambda eager: U._smooth_knn(knn, 64, eager=eager))
    a, b = U.fit_ab()
    for n, epochs in layout_cells:
        g = torch.Generator(device=dev).manual_seed(n)
        W = (W0 if n == n0 else
             fuzzy(torch.randn(n, 50, generator=g, device=dev))[0])
        Y0 = torch.randn(n, layout_dim, generator=g, device=dev)
        Y0 *= 10.0 / Y0.abs().max()
        pair(f'umap_layout {n} x {layout_dim}, {epochs} epochs, neg_rate 5',
             {'umap_layout': epochs}, epochs,
             lambda eager: U._optimize_layout(
                 W, Y0, torch.Generator(device=dev).manual_seed(0), epochs,
                 a, b, neg_rate=5, eager=eager))
        del W, Y0
    del W0, knn, x0
    torch.cuda.empty_cache()

    real_mmdma = compare._mmdma_opt

    def mmdma(eager):
        runs = []

        def opt(*a, **k):
            runs.extend(real_mmdma(*a, **k))
            return runs[-3:]
        with mock.patch.object(compare, '_mmdma_opt', opt):
            emb = compare.mmdma_embed(data, n_iters=mmdma_iters, device=dev,
                                      _eager=eager)
        return [torch.as_tensor(e) for e in emb] + runs
    pair(f'mmdma {n0} cells, 36 runs x 32, {mmdma_iters} iterations',
         {'mmdma': mmdma_iters}, mmdma_iters, mmdma)

    # A capture that raises leaves the process able to draw from the
    # default CUDA generator and to capture again
    x = torch.ones(4, device=dev)
    try:
        graphs.steps_runner('bad', lambda: x.add_(float(x.sum())), dev).run(3)
        bad.append('a step reading the host captured without an error')
    except RuntimeError:
        pass
    after = {}
    try:
        after['drawn_finite'] = bool(torch.isfinite(
            torch.rand(8, device=dev)).all())
        gen = torch.Generator(device=dev).manual_seed(1)
        y = torch.zeros(4, device=dev)
        good = graphs.steps_runner(
            'good', lambda: y.add_(torch.rand(4, device=dev, generator=gen)),
            dev, generators=[gen])
        good.run(3)
        after.update(captured=good.graph is not None,
                     replayed=bool((y > 0).all()))
    except RuntimeError as e:
        after['error'] = str(e)
    if after != {'drawn_finite': True, 'captured': True, 'replayed': True}:
        bad.append(f'after a failed capture: {after}')

    line = {'card': smi_line, 'runs': records,
            'after_failed_capture': after}
    print('solver_capture: ' + json.dumps(line, default=float), flush=True)
    if bad:
        fail('phase Q (the captured solver loops) failed: ' + '; '.join(bad))
    return captured_counts


# Phase R's record keys: each JAX example's record as its script builds it
# (examples/scgem.py main, comparison.py, imputation_comparison.py --scgem
# at one seed, scmnc_motor.py --partial, scmnc_motor_sweep.py,
# motor_provenance_fingerprint.py's last printed line, scmnc_visual.py
# --partial, scglue.py); tests/test_torch_examples_data.py holds them to
# the examples' stubbed runs. The fingerprint twin adds 'candidates', the
# lines the example prints before its last.
_PRIOR_KEYS = ('fit_seconds', 'foscttm', 'lta', 'lta_75', 'lta_50',
               'reference')
EXAMPLES_DATA_KEYS = {
    'scgem': set(_PRIOR_KEYS) | {
        f'imputation_{m}_mod{i}' for m in ('r', 'js_dist') for i in (1, 2)},
    'comparison': {'JAMIE', 'NLMA', 'LMA', 'CCA', 'MMD-MA', 'UnionCom',
                   'baseline_seconds', 'reference'},
    'imputation_comparison': {'n_seeds', 'dataset', 'total_seconds'} | {
        f'{m}_r_mod{i}_{s}' for m in ('jamie', 'knn', 'nn') for i in (1, 2)
        for s in ('mean', 'sd', 'runs')} | {
        f'jamie_gt_{b}_mod{i}_runs' for b in ('knn', 'nn') for i in (1, 2)},
    'scmnc_motor': set(_PRIOR_KEYS) | {'epochs_run'},
    'scmnc_motor_sweep': {'sweep', 'reference'},
    'motor_provenance_fingerprint': {'candidates', 'ranking', 'ref_trace'},
    'scmnc_visual': set(_PRIOR_KEYS) | {'epochs_run'},
    'scglue': set(_PRIOR_KEYS),
}
SWEEP_ROW_KEYS = {'lta_mean', 'lta_sd', 'foscttm_mean', 'seconds', 'runs'}


def _numbers(rec):
    """Every number in a record (strings, None and booleans aside)."""
    if isinstance(rec, dict):
        rec = list(rec.values())
    if isinstance(rec, (list, tuple)):
        return [x for v in rec for x in _numbers(v)]
    if isinstance(rec, (bool, str)) or rec is None:
        return []
    return [float(rec)]


def _foscttms(name, rec):
    """(where, FOSCTTM) of every FOSCTTM in a twin's record."""
    if name == 'comparison':
        return [(m, rec[m]['foscttm']) for m in rec
                if isinstance(rec[m], dict) and 'foscttm' in rec[m]]
    if name == 'scmnc_motor_sweep':
        return [(c, row['foscttm_mean']) for c, row in rec['sweep'].items()]
    return [('', rec['foscttm'])] if 'foscttm' in rec else []


def examples_data_phase(torch, ops, kp, dev, smi_line, epoch_dnn=100,
                        min_epochs=25, scgem_shape=(177, 230, 27),
                        motor_shape=(1208, 1286, 29),
                        visual_shape=(3654, 1302, 39),
                        scglue_shape=(2048, 28930, 241757), seed=0):
    """R. The real-data example twins (jamie_tpu_torch.examples), each
    through its main (scglue through `run`) on the card, on synthetic files
    in the datasets' formats at the published widths, written first into
    a temporary directory from RandomState(seed): scGEM's text files
    (scgem_shape: cells, genes, methylation features), the motor .rda
    (raw counts, e-features with a few NA, the 'RNA family' labels) and
    the visual CSVs (counts, e-features, metadata). scglue's modalities are
    made in memory at full width on scglue_shape[0] cells (the card's
    machine has no h5py) and z-scored by the example's `_zscore`. Only the
    epochs are cut: JAMIE's epoch_DNN and min_epochs; every fit keeps
    epoch_pd 2000. The counts are at 0 just before each twin. Fails if a
    twin exits early, a record lacks a key of the example's record, a
    FOSCTTM is 0.5 or above, a number in a record is not finite, or K1 is
    not launched 2000 times per fit (20,000 for UnionCom) or K3 not at
    all. K1 and K3 are first held to their plain versions at the shapes
    no earlier phase holds them at (scGEM's solve and distances, scglue's
    2048-cell RNA distances; phase N holds the motor and visual shapes).
    One `examples_data:` line. Returns the summed launch counts."""
    from jamie_tpu_torch.examples import comparison, imputation_comparison
    from jamie_tpu_torch.examples import motor_provenance_fingerprint as fp
    from jamie_tpu_torch.examples import (scgem, scglue, scmnc_motor,
                                          scmnc_motor_sweep, scmnc_visual)
    cuts = dict(epoch_DNN=epoch_dnn, min_epochs=min_epochs)
    cut_argv = ['--epoch-dnn', str(epoch_dnn), '--min-epochs',
                str(min_epochs)]
    sweep_names = ['logcpm_median', 'tmm_log']
    print(f'phase R: cuts: every JAMIE fit epoch_DNN={epoch_dnn} '
          f'min_epochs={min_epochs} (the examples: 10000 / 2500, early '
          'stop; comparison quick 3000 / 1000), epoch_pd 2000 kept; '
          'scgem main only (not --seeds / --imputation-seeds / '
          '--ablation-seeds); imputation_comparison --scgem --seeds 1 '
          f'(default 5); scmnc_motor --partial (not --seeds); '
          f'scmnc_motor_sweep --seeds 1 --only {",".join(sweep_names)} '
          '(default 2 seeds x 14 transforms); motor_provenance_fingerprint '
          '--confirm cpm1e4_log1p (geodesic) and --confirm '
          'pearson_theta100 --distance euclidean (not the 17-candidate '
          f'zoo); scglue.run on {scglue_shape[0]} of 9190 cells; the data '
          'synthetic', flush=True)

    n_imp = int(0.8 * scgem_shape[0])
    for n, dims in ((scgem_shape[0], scgem_shape[1:]),
                    (n_imp, scgem_shape[1:]),
                    (scglue_shape[0], scglue_shape[1:])):
        harness_kernels(kp, dev, n, dims)

    rows, total, bad = {}, {}, []

    def run(name, fn, fits):
        """fn() with the counts at 0; `fits` JAMIE fits of 2000 K1
        launches each (plus the extra K1 launches of `fits` if a tuple)."""
        ops.reset_launch_counts()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                rec = fn()
        except SystemExit as e:
            bad.append(f'{name} exited early (code {e.code})')
            return None
        sec = time.perf_counter() - t
        counts = ops.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        want = sum(fits) if isinstance(fits, tuple) else 2000 * fits
        if counts['fused_pd_grad_update'] != want:
            bad.append(f'{name}: K1 launched '
                       f'{counts["fused_pd_grad_update"]} times, expected '
                       f'{want}')
        if not counts['pairwise_euclidean']:
            bad.append(f'{name}: K3 never launched')
        keys = EXAMPLES_DATA_KEYS[name.split()[0]]
        if not keys <= set(rec):
            bad.append(f'{name}: record lacks {sorted(keys - set(rec))}')
        if name == 'scmnc_motor_sweep' and any(
                set(r) != SWEEP_ROW_KEYS for r in rec['sweep'].values()):
            bad.append(f'{name}: sweep rows {rec["sweep"]}')
        fos = _foscttms(name.split()[0], rec)
        for where, v in fos:
            if not v < 0.5:
                bad.append(f'{name} {where}: FOSCTTM {v} is not under 0.5')
        if not np.isfinite(_numbers(rec)).all():
            bad.append(f'{name}: a number in the record is not finite')
        rows[name] = {'seconds': sec, 'foscttm': dict(fos),
                      'launches': {k: v for k, v in counts.items() if v},
                      'record': rec}
        print(f'phase R {name}: {sec:.3f} s; FOSCTTM {dict(fos)}; launches '
              f'{rows[name]["launches"]}', flush=True)
        return rec

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(seed)
        t = time.perf_counter()
        dirs = {}
        for name, writer, shape in (
                ('scgem', write_scgem, scgem_shape),
                ('motor', write_motor_rda, motor_shape),
                ('visual', write_visual_csv, visual_shape)):
            dirs[name] = os.path.join(tmp, name)
            os.makedirs(dirs[name])
            writer(dirs[name], rng, n=shape[0], dims=shape[1:])
        write_s = time.perf_counter() - t
        print(f'phase R: files written in {write_s:.3f} s', flush=True)

        run('scgem', lambda: scgem.main(data_dir=dirs['scgem'], device=dev,
                                        cuts=cuts), 4)
        run('comparison', lambda: comparison.main(
            data_dir=dirs['scgem'], device=dev, cuts=cuts),
            (2000, 20000))
        run('imputation_comparison', lambda: (
            imputation_comparison.scgem_multi_seed(
                1, data_dir=dirs['scgem'], device=dev, cuts=cuts)), 1)
        run('scmnc_motor', lambda: scmnc_motor.main(
            partial=True, data_dir=dirs['motor'], device=dev, cuts=cuts), 3)
        run('scmnc_motor_sweep', lambda: scmnc_motor_sweep.main(
            ['--seeds', '1', '--only', ','.join(sweep_names), '--data-dir',
             dirs['motor'], '--device', str(dev), *cut_argv]),
            len(sweep_names))
        run('motor_provenance_fingerprint geodesic', lambda: fp.main(
            ['--confirm', 'cpm1e4_log1p', '--data-dir', dirs['motor'],
             '--device', str(dev)]), 1)
        run('motor_provenance_fingerprint euclidean', lambda: fp.main(
            ['--confirm', 'pearson_theta100', '--distance', 'euclidean',
             '--data-dir', dirs['motor'], '--device', str(dev)]), 1)
        for tag in ('geodesic', 'euclidean'):
            rec = rows.get(f'motor_provenance_fingerprint {tag}',
                           {}).get('record')
            if rec and sorted(rec['candidates'][0]['trace']) != [
                    500, 1000, 1500, 2000]:
                bad.append(f'fingerprint {tag}: parsed epochs '
                           f'{sorted(rec["candidates"][0]["trace"])}')
        run('scmnc_visual', lambda: scmnc_visual.main(
            partial=True, data_dir=dirs['visual'], device=dev, cuts=cuts), 3)

    t = time.perf_counter()
    n, f_rna, f_atac = scglue_shape
    atac, rna, labels = scglue_on_card(torch, dev, n=n, f_atac=f_atac,
                                       f_rna=f_rna, return_labels=True)
    dataset = [scglue._zscore(rna), scglue._zscore(atac.toarray())]
    del atac, rna
    types = [np.array([f'type{t}' for t in labels])] * 2
    data_s = time.perf_counter() - t
    print(f'phase R: scglue modalities made in {data_s:.3f} s', flush=True)
    run('scglue', lambda: scglue.run(dataset, types, device=dev, cuts=cuts),
        3)
    del dataset
    torch.cuda.empty_cache()

    line = {'card': smi_line, 'cuts': cuts, 'write_s': write_s,
            'scglue_data_s': data_s,
            'twins': {k: {'seconds': v['seconds'], 'foscttm': v['foscttm'],
                          'lta': {m: r for m, r in v['record'].items()
                                  if m.startswith('lta')},
                          'launches': v['launches']}
                      for k, v in rows.items()},
            'comparison': {m: rows['comparison']['record'][m]
                           for m in ('JAMIE', 'NLMA', 'LMA', 'CCA', 'MMD-MA',
                                     'UnionCom')}
            if 'comparison' in rows else None,
            'launches': total}
    print('examples_data: ' + json.dumps(line, default=float), flush=True)
    if not (total.get('fused_pd_grad_update') and
            total.get('pairwise_euclidean')):
        bad.append(f'K1 or K3 not launched in the phase: {total}')
    if bad:
        fail('phase R (the real-data examples) failed: ' + '; '.join(bad))
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this run needs a CUDA card')
    try:
        from jamie_tpu_torch import JAMIE, ops
        from jamie_tpu_torch.core import graphs
        from jamie_tpu_torch.core.dtypes import MM_OUT_DTYPE_ON_CUDA
        from jamie_tpu_torch.ops import _build
        from jamie_tpu_torch.probes import snare_like
        from jamie_tpu_torch.solvers.prime_dual import prime_dual
        from jamie_tpu_torch.train import trainer as T
    except ImportError as e:
        fail(f'jamie_tpu_torch is not importable next to this script: {e}')
    t_start = time.perf_counter()

    # 1. Device
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    smi_line = smi[0]
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    import triton
    print(f'device: {smi_line} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} triton {triton.__version__} | bf16 matmul route: '
          f'{"mm_out_dtype" if MM_OUT_DTYPE_ON_CUDA else "rounded_f32"}',
          flush=True)

    # 2. Build every kernel from this checkout's sources
    t = time.perf_counter()
    lib = _build.load('pairwise_sq_euclidean')
    smem = lib.pairwise_sq_euclidean_smem_bytes()
    usage = [ln.strip() for ln in
             _build.build_log('pairwise_sq_euclidean').splitlines()
             if any(w in ln for w in ('Used', 'spill', 'warning',
                                      'Compiling entry'))]
    print(f'build: nvcc csrc/pairwise_sq_euclidean.cu '
          f'{time.perf_counter() - t:.2f} s; ptxas: {usage}; dynamic shared '
          f'memory {smem} bytes per block')
    route, evidence = mma_route(_build.library_path('pairwise_sq_euclidean'))
    print(f'K3 MMA route: {route} ({evidence})', flush=True)
    if route not in ('wgmma', 'mma.sync', 'unknown'):
        fail(f'K3 was built without tensor-core instructions ({evidence})')
    t = time.perf_counter()
    dev = torch.device('cuda')
    tiny = torch.zeros((8, 8), device=dev)
    a0 = torch.zeros((), device=dev)
    col, row = torch.zeros((8, 1), device=dev), torch.zeros((1, 8), device=dev)
    for m1 in (tiny, tiny.bfloat16()):
        ops.fused_pd_grad_update(tiny, m1, tiny, tiny, m1, col, col, col, col,
                                 row, a0, 1, 1e-3, 10.0)
        ops.fused_pd_update(tiny, m1, tiny, tiny, 1, 1e-3)
    torch.cuda.synchronize()
    print(f'build: triton ops/pd_update.py {time.perf_counter() - t:.2f} s',
          flush=True)

    # 3. Kernels against their plain versions
    kp = KernelPhase(torch, *peaks)
    data, labels = snare_like()
    k1_calls = {}
    for (m, n, dt) in ((1047, 1047, torch.float32), (1047, 1047, torch.bfloat16),
                       (1000, 1037, torch.float32), (9190, 9190, torch.float32),
                       (9190, 9190, torch.bfloat16)):
        k1_calls[(m, n, dt)] = kp.pd_update(m, n, dt)
    kp.pd_update(1047, 1047, torch.float32, has_grad=False)
    # Phase L's solve (24,000^2, f32 state) and the largest dense solve the
    # default thresholds allow (LANDMARK_AUTO_ENTRIES, bf16 state), whose
    # plain version runs on its last 2048 rows
    from jamie_tpu_torch import estimator as E
    kp.pd_update(24000, 24000, torch.float32)
    nb = math.isqrt(E.LANDMARK_AUTO_ENTRIES)
    kp.pd_update(nb, nb, torch.bfloat16, plain_rows=2048)
    torch.cuda.empty_cache()
    # Phase L's K3 shapes: the RNA distances (24,000 x 3000, self sqrt; the
    # 120M-element ATAC takes the bf16-resident Gram) and one row block of
    # its blocked FOSCTTM (cross squared on the 32-dimensional embeddings)
    from jamie_tpu_torch import evaluation
    g = kp.gen
    kp.pairwise(torch.randn(24000, 3000, device=dev, generator=g), None,
                squared=False)
    bs24 = max(evaluation._FOSCTTM_BLOCK_ENTRIES // 24000, 256)
    kp.pairwise(torch.randn(bs24, 32, device=dev, generator=g),
                torch.randn(24000, 32, device=dev, generator=g), squared=True)
    torch.cuda.empty_cache()
    # K1's block size and warps are constants of ops/pd_update.py, chosen
    # from this sweep (device ms per call)
    from jamie_tpu_torch.ops import pd_update as K
    for (m, n) in ((1047, 1047), (9190, 9190)):
        _, args = k1_calls[(m, n, torch.float32)]
        F, M1, M2, mm4, kx, Mu, Lam, S, rs, cs, a_, i_, eps_, rho_ = args
        vecs = [v.reshape(-1) for v in (Mu, Lam, S, rs, cs)]
        sweep = {}
        for block, warps in ((1024, 4), (2048, 4), (2048, 8), (4096, 4),
                             (4096, 8)):
            sweep[f'{block}/{warps}'] = round(time_ms(torch, lambda: K._launch(
                F, M1, M2, mm4, kx, vecs, rho_, a_, i_, eps_, True,
                block=block, num_warps=warps))[0], 5)
        print(f'K1 sweep {m}x{n} M1=float32 (BLOCK/num_warps: device ms; '
              f'chosen {K.BLOCK}/{K.NUM_WARPS}): {sweep}', flush=True)
    # The device kernels of one K1 call with the solver's step counter:
    # the one (m, n) pass and the bias corrections' pow and subtraction
    kern, args = k1_calls[(1047, 1047, torch.float32)]
    n_k, launched = device_kernels(torch, lambda: kern(*args))
    print(f'device kernels per call: K1 1047x1047 {n_k} (wrapper launches '
          f'{launched})', flush=True)
    if n_k != 3 or launched != {kern.__name__: 1}:
        fail(f'one K1 call issued {n_k} device kernels and {launched} '
             f'wrapper launches, expected its kernel once and 2 for its '
             f'bias corrections')
    x_rna = torch.as_tensor(data[0], device=dev)
    x_atac = torch.as_tensor(data[1], device=dev)
    emb = [torch.randn(1047, 32, device=dev, generator=g) for _ in range(2)]
    kp.pairwise(x_rna, None, squared=False)          # geodesic base, RNA
    kp.pairwise(x_atac, None, squared=False)         # geodesic base, ATAC
    from jamie_tpu_torch.ops import pairwise as P
    for xa, ya in ((x_atac, None), (x_rna, None)):
        n_k, launched = device_kernels(
            torch, lambda: P.pairwise_euclidean(xa, ya, squared=False))
        stated = P.device_kernels_per_call(xa, ya)
        m_, f_ = xa.shape
        splits = P.launch_plan(m_, m_, f_, P._num_sms(0))[1]
        print(f'device kernels per call: K3 {m_}x{m_}x{f_} self sqrt '
              f'{n_k} (stated {stated}, split-K {splits}, wrapper launches '
              f'{launched})', flush=True)
        if not 1 <= n_k <= stated or launched != {'pairwise_euclidean': 1}:
            fail(f'one K3 call issued {n_k} device kernels and {launched} '
                 f'wrapper launches, stated {stated} and 1')
    kp.pairwise(emb[0], emb[1], squared=True)        # FOSCTTM / kNN
    kp.pairwise(emb[0], None, squared=True)          # t-SNE step, 1047 cells
    kp.pairwise(x_atac, None, squared=True)
    kp.pairwise(x_atac, x_atac.flip(0).contiguous(), squared=False)
    kp.pairwise(x_atac, x_atac.flip(0).contiguous(), squared=True)
    # Phase K's geodesic bases: each rank's row block against the whole
    # matrix (cross sqrt; at world size 1 the block is every row)
    kp.pairwise(x_rna, x_rna, squared=False)
    kp.pairwise(x_atac, x_atac, squared=False)
    # Phase J's cases: _binary_knn's self squared on the raw RNA (ATAC's is
    # above) and on a PCA-512 view, predict_knn's cross squared of the RNA
    # against itself, knn_dist's self squared on a PCA-16 view, gw_loss's
    # self sqrt and the silhouette's cross sqrt (one row block against
    # every row) on 32-dimensional embeddings
    kp.pairwise(x_rna, None, squared=True)
    kp.pairwise(torch.randn(1047, 512, device=dev, generator=g), None,
                squared=True)
    kp.pairwise(x_rna, x_rna, squared=True)
    kp.pairwise(torch.randn(1047, 16, device=dev, generator=g), None,
                squared=True)
    kp.pairwise(emb[0], None, squared=False)
    kp.pairwise(emb[0], emb[0], squared=False)
    xr = torch.randn(1000, 333, device=dev, generator=g)
    yr = torch.randn(1037, 333, device=dev, generator=g)
    kp.pairwise(xr, yr, squared=True)
    kp.pairwise(xr, None, squared=False)
    big = torch.randn(9190, 28930, device=dev, generator=g)
    big2 = torch.randn(9190, 28930, device=dev, generator=g)
    for y in (None, big2):
        for sq in (True, False):
            kp.pairwise(big, y, squared=sq)
    del big, big2, xr, yr
    kp.pairwise(torch.randn(9190, 32, device=dev, generator=g), None,
                squared=True)                        # t-SNE step, 9190 cells
    torch.cuda.empty_cache()
    # The landmark path's shapes on 19,000 cells: K1 on the 2048x2048
    # landmark solve; K3 self sqrt on the landmark subsets (geodesic base),
    # cross squared from an 8192-row block of cells to the landmarks, and
    # cross squared on one row block of the blocked FOSCTTM / kNN
    t = time.perf_counter()
    data19, labels19 = snare_like(n=19000)
    print(f'data: 19000 cells generated in {time.perf_counter() - t:.2f} s',
          flush=True)
    kp.pd_update(2048, 2048, torch.float32)
    lm_rows = np.sort(np.random.RandomState(0).choice(19000, 2048,
                                                      replace=False))
    for x_host in data19:
        cells = torch.as_tensor(x_host[:8192], device=dev)
        lms = torch.as_tensor(x_host[lm_rows], device=dev)
        kp.pairwise(lms, None, squared=False)
        kp.pairwise(cells, lms, squared=True)
    emb19 = torch.randn(19000, 32, device=dev, generator=g)
    bs19 = max(evaluation._FOSCTTM_BLOCK_ENTRIES // 19000, 256)
    kp.pairwise(emb19[:bs19], torch.randn(19000, 32, device=dev, generator=g),
                squared=True)
    del cells, lms, emb19
    torch.cuda.empty_cache()
    # The 100,000-cell atlas path's K3 shapes: self sqrt on the densified
    # 2048-cell landmark subsets (20,000 RNA / 40,000 ATAC features, the
    # geodesic base) and one row block of the exact blocked FOSCTTM / kNN
    (lm_rna, lm_atac), _ = atlas_on_card(torch, dev, 2048, dense=True)
    kp.pairwise(lm_rna, None, squared=False)
    kp.pairwise(lm_atac, None, squared=False)
    del lm_rna, lm_atac
    bs100 = max(evaluation._FOSCTTM_BLOCK_ENTRIES // 100_000, 256)
    kp.pairwise(torch.randn(bs100, 32, device=dev, generator=g),
                torch.randn(100_000, 32, device=dev, generator=g),
                squared=True)
    torch.cuda.empty_cache()

    # 4. Fit, with every launch count at 0 just before it
    kw = dict(epoch_DNN=20, min_epochs=10, use_early_stop=False)
    jm = JAMIE(**kw)
    ops.reset_launch_counts()
    T.epoch_routes.clear()
    graphs.loop_steps.clear()
    t = time.perf_counter()
    integrated = jm.fit_transform(dataset=data)
    fit_s = time.perf_counter() - t
    fit_counts = ops.launch_counts()
    print(f'fit: {fit_s:.3f} s; phases {jm.phase_timings}; mapping '
          f'{ {k: round(v, 3) for k, v in jm._mapping_timings.items()} }; '
          f'launches {fit_counts}; epochs {dict(T.epoch_routes)}; graphs '
          f'{jm.trainer.graph_stats}', flush=True)
    if dict(T.epoch_routes) != {'captured': jm.epochs_run}:
        fail(f'the fit trained {dict(T.epoch_routes)} epochs by route, '
             f'expected all {jm.epochs_run} captured')
    if fit_counts['fused_pd_grad_update'] != jm.config.epoch_pd:
        fail(f'K1 launched {fit_counts["fused_pd_grad_update"]} times in the '
             f'fit, expected epoch_pd={jm.config.epoch_pd}')
    if fit_counts['pairwise_euclidean'] < 2:
        fail('K3 launched fewer than 2 times in the fit')
    for i, e in enumerate(integrated):
        if e.shape != (1047, 32) or not np.isfinite(e).all():
            fail(f'embedding {i}: shape {e.shape}, finite {np.isfinite(e).all()}')
    # Metrics, a path of their own: FOSCTTM's distances go through K3
    ops.reset_launch_counts()
    foscttm = jm.test_closer(integrated)
    lta = jm.test_LabelTA(integrated, [labels, labels])
    metric_counts = ops.launch_counts()
    if not (np.isfinite(foscttm) and np.isfinite(lta)):
        fail(f'non-finite metrics: FOSCTTM {foscttm}, LTA {lta}')
    print(f'metrics: FOSCTTM {foscttm} LTA {lta} epochs {jm.epochs_run} '
          f'train {jm.fit_seconds:.3f} s; launches {metric_counts}',
          flush=True)
    if metric_counts['pairwise_euclidean'] < 1:
        fail('K3 was not launched by the metrics')

    # 5. Serve: transform, imputation, checkpoint round trip
    ops.reset_launch_counts()
    t = time.perf_counter()
    emb_t = jm.transform(data)
    imputed = jm.modal_predict(data[0], 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'model.npz')
        jm.save_model(path)
        imputed2 = JAMIE().load_model(path).modal_predict(data[0], 0)
    serve_s = time.perf_counter() - t
    if not np.array_equal(imputed, imputed2):
        fail(f'modal_predict differs after save/load: max '
             f'{np.abs(imputed - imputed2).max()}')
    if (imputed.shape != data[1].shape or not np.isfinite(imputed).all()
            or not np.allclose(emb_t[0], integrated[0], rtol=1e-5, atol=1e-5)):
        fail('serve outputs are off')
    serve_counts = ops.launch_counts()
    print(f'serve: {serve_s:.3f} s; transform == fit output; modal_predict '
          f'identical after save/load; launches {serve_counts}', flush=True)

    # Reference on a small input: the same solve on the card and on the CPU,
    # for each precision arm. 'default' is the fit's arm: bf16 operands with
    # an f32 result, through torch.mm(out_dtype=float32) on the card and
    # rounded-f32 operands on the CPU. Tolerances (of max F, 50 iterations)
    # are those of tests/test_torch_prime_dual.py: f32 summation order only
    # for 'highest' and 'default'; one bf16 ulp in the stored state for
    # state_dtype='bfloat16'.
    rng = np.random.RandomState(3)
    xs = rng.randn(64, 5).astype(np.float32)
    Kx = ((xs[:, None] - xs[None]) ** 2).sum(-1)
    Ky = Kx[::-1, ::-1].copy()
    for precision, state_dtype, tol in (('highest', 'float32', 1e-4),
                                        ('default', 'float32', 1e-4),
                                        ('default', 'bfloat16', 1e-3)):
        kw = dict(epoch_pd=50, verbose=False, precision=precision,
                  state_dtype=state_dtype)
        F_gpu = prime_dual(Kx, Ky, 5, 5, **kw).cpu().numpy()
        F_cpu = prime_dual(Kx, Ky, 5, 5, device='cpu', **kw).numpy()
        pd_err = float(np.abs(F_gpu - F_cpu).max())
        limit = tol * float(np.abs(F_cpu).max())
        print(f'reference: prime_dual 64x64x50 precision={precision} '
              f'state_dtype={state_dtype} card vs CPU max |dF| {pd_err} '
              f'(limit {limit})', flush=True)
        if not pd_err <= limit:
            fail(f'prime_dual ({precision}, {state_dtype}) on the card '
                 f'disagrees with the CPU')

    # 6. Partial prior: the first fit's F, half the cells paired
    partial_prior_phase(JAMIE, ops, jm.match_result, data)
    # 7. The landmark path on 19,000 cells
    X19 = landmark_fit_phase(torch, JAMIE, ops, data19, labels19)
    layouts19 = landmark_layout_phase(torch, data19, dev)
    del data19
    landmark_reference_phase(dev)
    # 9-11. The sparse and atlas input path
    sparse_reference_phase(torch, dev)
    wide_phase(torch, kp, dev)
    atlas_phase(torch, JAMIE, ops, kp, dev)
    # D-H. The nonlinear and legacy modes
    jt = tsne_fit_phase(torch, JAMIE, ops, data, TSNE_FOSCTTM_LIMIT)
    tsne_reference_phase(torch, dev)
    preclass_phase(torch, JAMIE, ops, data, dev)
    lowrank_phase(torch, jt)
    metrics_phase(torch, dev, data[0])
    from jamie_tpu_torch.solvers.tsne import joint_probabilities
    tsne_scale_phase(torch, ops, kp, dev,
                     [joint_probabilities(d, 30, device=dev) for d in jt.dist],
                     200, "1047 cells, the fit's P")
    del jt
    tsne_scale_phase(torch, ops, kp, dev,
                     scglue_cells_probabilities(torch, dev), 1000,
                     "scGLUE's 9190 cells")
    # I. The raw-file workflow around the fit
    workflow_phase(torch, JAMIE, ops, data, labels, dev, smi_line)
    # J. The analysis and baseline modules
    compare_phase(torch, ops, data, labels, dev, smi_line)
    # K. The mesh path at world size 1, against the fit of step 4
    t = time.perf_counter()
    twins = mesh_phase(torch, JAMIE, ops, data, dev, integrated, foscttm,
                       fit_s, jm.phase_timings, smi_line,
                       dict(epoch_DNN=20, min_epochs=10,
                            use_early_stop=False))
    print(f'phase K: {time.perf_counter() - t:.1f} s', flush=True)
    # L. The card's route thresholds: a dense fit past 520M entries
    thresholds_phase(torch, JAMIE, ops, dev, smi_line)
    # M-N. The benchmark harnesses at the published shapes
    path_counts = {'fit': fit_counts,
                   'bench': bench_phase(torch, ops, kp, dev, smi_line),
                   'time_and_memory': harness_phase(torch, ops, kp, dev,
                                                    smi_line)}
    # O. The synthetic-data examples, each through its main
    t = time.perf_counter()
    path_counts['examples'] = examples_phase(torch, ops, kp, dev, smi_line)
    print(f'phase O: {time.perf_counter() - t:.1f} s', flush=True)
    # Every epoch since step 4 trained captured, on one device or on the
    # mesh, but those of phase K's eager twins
    routes = dict(T.epoch_routes)
    print(f'epochs by route since step 4: {routes}', flush=True)
    if (routes.get('eager') or not routes.get('captured')
            or not routes.get('mesh_captured')
            or routes.get('mesh', 0) != twins['epochs']):
        fail(f'epochs by route {routes}: expected every epoch captured but '
             f"the {twins['epochs']} of phase K's eager twins")

    # P. The captured trainer against its eager epoch body
    t = time.perf_counter()
    train_capture_phase(torch, dev, smi_line,
                        (list(jm.trainer.data), jm.P, jm.match_result[0]),
                        (X19, *layouts19))
    print(f'phase P: {time.perf_counter() - t:.1f} s', flush=True)

    # Q. The captured solver loops against their eager steps. Every solver
    # loop on the card since step 4 ran captured, phase K's mesh solves
    # with their collectives, but the iterations of phase K's eager twins;
    # the CPU references run on the 'cpu' route
    steps = dict(graphs.loop_steps)
    print(f'solver loop steps by route since step 4: {steps}', flush=True)
    eager = {k: v for k, v in steps.items() if k.endswith('/eager')}
    ran = {k.split('/')[0] for k in steps if k.endswith('/captured')}
    loops = {'prime_dual', 'fps', 'tsne_beta', 'tsne', 'tsne_single',
             'lowrank_cluster', 'lowrank_cast', 'umap_sigma', 'umap_layout',
             'mmdma'}
    mesh_steps = {k: v for k, v in steps.items() if k.endswith('/mesh')}
    if (eager or ran != loops or not steps.get('prime_dual/mesh_captured')
            or mesh_steps != {'prime_dual/mesh': twins['pd_steps']}):
        fail(f'solver loops ran {steps}: expected every step of '
             f'{sorted(loops)} captured, the mesh solves too, but the '
             f"{twins['pd_steps']} of phase K's eager twins")
    t = time.perf_counter()
    path_counts['solver_capture'] = solver_capture_phase(
        torch, ops, dev, smi_line, X19[0], data)
    print(f'phase Q: {time.perf_counter() - t:.1f} s', flush=True)

    # R. The real-data examples on synthetic files in their formats
    t = time.perf_counter()
    path_counts['examples_data'] = examples_data_phase(torch, ops, kp, dev,
                                                       smi_line)
    print(f'phase R: {time.perf_counter() - t:.1f} s', flush=True)

    # 8. The kernels line, the device line, the result
    main_case = {'pd_grad_update': '1047x1047 M1=float32',
                 'pd_update': '1047x1047 M1=float32',
                 'pairwise_euclidean': '1047x1047x5000 self sqrt'}
    meta = {
        'pd_grad_update': ('fused_pd_grad_update', 'triton',
                           'jamie_tpu_torch/ops/pd_update.py',
                           'jamie_tpu/ops/ab_archive.py:137'),
        'pd_update': ('fused_pd_update', 'triton',
                      'jamie_tpu_torch/ops/pd_update.py',
                      'jamie_tpu/ops/ab_archive.py:180'),
        'pairwise_euclidean': ('pairwise_euclidean', 'cuda',
                               'jamie_tpu_torch/csrc/pairwise_sq_euclidean.cu',
                               'jamie_tpu/ops/ab_archive.py:232'),
    }
    kernels = []
    for key, case in main_case.items():
        row = next(r for r in kp.rows if r['kernel'] == key and r['case'] == case)
        fn, route, source, replaces = meta[key]
        kernels.append(dict(
            name=key, route=route, source=source, replaces=replaces,
            launches=fit_counts[fn], max_abs_err=row['max_abs_err'],
            ms=row['ms'], plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
            bound_by=row['bound_by'], library_ms=row['library_ms'],
            launches_by_path={p: c[fn] for p, c in path_counts.items()}))
    print(f'total: {time.perf_counter() - t_start:.1f} s', flush=True)
    print(json.dumps({'kernels': kernels}))
    print(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
