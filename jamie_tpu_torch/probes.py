"""Probes of the memory and time behind the route thresholds, on one card.

    python -m jamie_tpu_torch.probes solver [--sizes N ...]
    python -m jamie_tpu_torch.probes fit [--sizes N|N0xN1 ...] [--resident GIB]
    python -m jamie_tpu_torch.probes fit --atlas CELLS
    python -m jamie_tpu_torch.probes residency [--dense N F] [--csr N F]
    python -m jamie_tpu_torch.probes quality

The module globals that choose a route (`route_thresholds()` lists them)
rest on these measurements. Each probe prints one JSON line per rung and
returns the records; every record carries the card's `nvidia-smi` name and
power limit (`smi`), `max_memory_allocated` since the rung began,
`mem_get_info` (free, total), the host's peak RSS during the rung and the
seconds the rung took. On the CPU the device fields are None. A rung that
runs out of device memory is reported with `ok: false` and its error, and
ends its ladder; it is never counted as passed.

- `solver`: `solvers/prime_dual.prime_dual` at a ladder of square N, for
  f32 and bf16 state with bf16 GEMMs, on distance-shaped operands made on
  the device (symmetric, zero diagonal, nonnegative), with `verbose=True`
  as the estimator runs it, so each run passes one `log_pd` step and its
  two extra (N, N) f32 temporaries. Seconds per iteration come from the
  difference of two run lengths with one log step each.
- `fit`: `JAMIE().fit_transform` at N0 x N1 cells of the SNARE-shaped
  generator (3000 / 5000 features, pca_dim 512) with
  `LANDMARK_AUTO_ENTRIES` lifted so the dense route runs at every rung;
  the device and host peaks, the phase split and `/proc/meminfo`.
  `--resident` sizes both modalities to the residency budget instead.
  `--atlas` instead fits the sparse 12-cluster multiome at that many cells with `corr_landmarks=2048` at the
  default thresholds, with the routes it took.
- `residency`: dense and 0/1 CSR matrices through the distance, PCA, FPS
  and landmark-weight routes, each route forced by patching the globals:
  exact f32 on the device, bf16-resident, streamed. Also the SpMM
  sketch's row block and the metrics' block size.
- `quality`: FOSCTTM and LTA of paired arms over a few seeds: f32 against
  bf16 solver state, exact f32 inputs against bf16-rounded ones, and dense
  against landmark F at a size past 520M entries.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import resource
import subprocess
import time
import warnings
from typing import Callable, List, Optional, Sequence
from unittest import mock

import numpy as np
import torch

from . import estimator as est
from . import evaluation
from . import preprocess
from .core import residency, timing
from .core.dtypes import resolve_device
from .ops import distances
from .ops.lowrank import LowRankF
from .solvers import landmark
from .solvers.prime_dual import prime_dual
from .synth import make_snare_like as snare_like

# Bytes the dense solver keeps per (N0 * N1) entry between iterations, by
# state dtype, with bf16 GEMMs (solvers/prime_dual.init_state): F, M1,
# M2, FKy, KxFKy and, for square N, Kx and Ky.
STATE_BYTES_PER_ENTRY = {'float32': 28, 'bfloat16': 18}

# Larger than any probed size: lifts a threshold so a route always engages
_NEVER = 1 << 62


def route_thresholds() -> dict:
    """Every module global that chooses a route, by its module-qualified
    name, at its current value."""
    return {
        'estimator.SENTINEL_ENTRIES': est.SENTINEL_ENTRIES,
        'estimator.DENSE_F32_STATE_ENTRIES': est.DENSE_F32_STATE_ENTRIES,
        'estimator.LANDMARK_AUTO_ENTRIES': est.LANDMARK_AUTO_ENTRIES,
        'core.residency.DEFAULT_BUDGET_BYTES': residency.DEFAULT_BUDGET_BYTES,
        'core.residency.BF16_LINK_ELEMS': residency.BF16_LINK_ELEMS,
        'ops.distances._FEATURE_CHUNK_THRESHOLD':
            distances._FEATURE_CHUNK_THRESHOLD,
        'preprocess._STREAM_THRESHOLD': preprocess._STREAM_THRESHOLD,
        'preprocess._SKETCH_SPMM_ROWS': preprocess._SKETCH_SPMM_ROWS,
        'solvers.landmark._FPS_BYTES_BUDGET': landmark._FPS_BYTES_BUDGET,
        'solvers.landmark._UPLOAD_ELEMS': landmark._UPLOAD_ELEMS,
        'solvers.landmark._SPARSE_FACTOR_ENTRIES':
            landmark._SPARSE_FACTOR_ENTRIES,
        'evaluation._FOSCTTM_BLOCK_ENTRIES': evaluation._FOSCTTM_BLOCK_ENTRIES,
    }


# ----------------------------------------------------------------- records
def smi_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _host_peak_reset() -> bool:
    """Start a new host peak-RSS window (Linux: VmHWM := VmRSS); False
    where the system refuses, and the peak is then the process's."""
    try:
        with open('/proc/self/clear_refs', 'w') as f:
            f.write('5')
    except OSError:
        return False
    return True


def _host_peak_rss() -> int:
    """Peak resident bytes of this process since the last reset (VmHWM),
    or since it started where /proc has no VmHWM."""
    with contextlib.suppress(OSError):
        with open('/proc/self/status') as f:
            for line in f:
                if line.startswith('VmHWM:'):
                    return int(line.split()[1]) * 1024
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def host_meminfo() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo in bytes ({} without)."""
    out = {}
    with contextlib.suppress(OSError):
        with open('/proc/meminfo') as f:
            for line in f:
                key, val = line.split(':', 1)
                if key in ('MemTotal', 'MemAvailable'):
                    out[key] = int(val.split()[0]) * 1024
    return out


def _sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _release(device) -> None:
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def _routes(span) -> dict:
    """The routes taken under `span`, without the device loops' steps."""
    return {k: v for k, v in timing.routes(span).items() if '/' not in k}


class _Rung:
    """The measuring window of one rung: resets the device and host peaks
    on entry; `record(**fields)` adds the common fields."""

    def __init__(self, probe: str, device, smi: Optional[str]):
        self.probe, self.device, self.smi = probe, device, smi

    def __enter__(self):
        _release(self.device)
        if self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)
        self.peak_scope = 'rung' if _host_peak_reset() else 'process'
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        return False

    def record(self, **fields) -> dict:
        _sync(self.device)
        cuda = self.device.type == 'cuda'
        rec = {'probe': self.probe, **fields, 'smi': self.smi,
               'max_memory_allocated': (
                   torch.cuda.max_memory_allocated(self.device) if cuda
                   else None),
               'mem_get_info': (list(torch.cuda.mem_get_info(self.device))
                                if cuda else None),
               'host_peak_rss': _host_peak_rss(),
               'host_peak_scope': self.peak_scope,
               'seconds': time.perf_counter() - self.t0}
        rec.setdefault('ok', True)
        return rec


def _print(line: str) -> None:
    print(line, flush=True)


def _emit(records: list, rec: dict, out: Callable) -> dict:
    records.append(rec)
    out(json.dumps(rec))
    return rec


# -------------------------------------------------------------------- data
def _host_csr(blocks, n, f):
    """A host scipy CSR (n, f) from an iterable of dense row blocks, each
    converted to CSR on its own device, so no dense (n, f) host array
    exists."""
    import scipy.sparse as sp
    indptr, cols, vals, nnz = [np.zeros(1, np.int64)], [], [], 0
    for blk in blocks:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', UserWarning)   # "beta state"
            c = blk.to_sparse_csr()
        indptr.append((c.crow_indices()[1:] + nnz).cpu().numpy())
        cols.append(c.col_indices().to(torch.int32).cpu().numpy())
        vals.append(c.values().cpu().numpy())
        nnz = int(indptr[-1][-1])
    ip = np.concatenate(indptr)
    return sp.csr_matrix((np.concatenate(vals), np.concatenate(cols),
                          ip.astype(np.int32 if nnz < 2 ** 31 else np.int64)),
                         shape=(n, f))


def _quantile(gen, block, q):
    flat = block.reshape(-1)
    idx = torch.randint(0, flat.numel(), (min(flat.numel(), 1 << 22),),
                        generator=gen, device=flat.device)
    return float(torch.quantile(flat[idx], q))


def latent_pair(n, dims=(20000, 40000), density=0.03, seed=0, device=None,
                rows=4096):
    """The 12-cluster sparse multiome of examples/synth.py (a
    24-dimensional latent around 12 cluster centres, each modality
    relu(z W + 0.3 noise - cutoff) with the cutoff at the first rows' (1 -
    density) quantile), made on `device` from a seeded torch.Generator and
    returned as host CSR matrices with the labels."""
    dev = resolve_device(device)
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
        cut = _quantile(g, fill(0, min(rows, n)), 1.0 - density)
        out.append(_host_csr(((fill(s, min(s + rows, n)) - cut).clamp_(min=0)
                              for s in range(0, n, rows)), n, d))
    return out, assign.cpu().numpy()


def wide_matrix(n, f, sparse: bool, density=0.05, seed=1, device=None,
                rows=1024):
    """A wide modality of scGLUE's kind made on `device`: an 8-dimensional
    latent around 6 centres; as 0/1 peaks above the (1 - density) quantile
    (host CSR) or as dense relu(z W + 0.5 noise) (host f32)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(n, 8, generator=g, device=dev)
    z += 3.0 * torch.randn(6, 8, generator=g, device=dev)[
        torch.randint(0, 6, (n,), generator=g, device=dev)]
    w = torch.randn(8, f, generator=g, device=dev)

    def logits(s, e, noise):
        xb = z[s:e] @ w
        xb += noise * torch.randn(xb.shape, generator=g, device=dev)
        return xb
    if sparse:
        cut = _quantile(g, logits(0, min(rows, n), 1.0), 1.0 - density)
        return _host_csr(((logits(s, min(s + rows, n), 1.0) > cut).float()
                          for s in range(0, n, rows)), n, f)
    out = np.empty((n, f), np.float32)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        out[s:e] = logits(s, e, 0.5).clamp_(min=0).cpu().numpy()
    return out


def distance_operand(n, seed, device, dim=32):
    """A distance-shaped (n, n) f32 matrix on `device`: euclidean distances
    of n Gaussian points in `dim` dimensions (symmetric, zero diagonal,
    nonnegative), built in place."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, dim, generator=g, device=device)
    sq = (x * x).sum(1)
    K = x @ x.T
    K.mul_(-2.0).add_(sq[:, None]).add_(sq[None, :]).clamp_(min=0).sqrt_()
    K.fill_diagonal_(0.0)
    return K


# ------------------------------------------------------------------ solver
def probe_solver(sizes: Sequence[int],
                 state_dtypes: Sequence[str] = ('float32', 'bfloat16'),
                 iters: Sequence[int] = (2, 6), device=None,
                 out: Callable = _print) -> List[dict]:
    """The dense solver's ceiling and seconds per iteration at each N of
    `sizes`, per state dtype, until the first out-of-memory rung."""
    device = resolve_device(device)
    smi, records = smi_line(), []
    short, long_ = iters
    # builds K1 and starts cuBLAS before any rung is timed
    warm = distance_operand(256, 0, device)
    prime_dual(warm, warm, dx=32, dy=32, epoch_pd=2, verbose=False,
               device=device)
    for st in state_dtypes:
        for n in sizes:
            fields = dict(n=n, entries=n * n, state_dtype=st,
                          iters=list(iters),
                          state_bytes=(STATE_BYTES_PER_ENTRY[st] + 8) * n * n)
            with _Rung('solver', device, smi) as rung:
                try:
                    Kx = distance_operand(n, 0, device)
                    Ky = distance_operand(n, 1, device)
                    secs, finite = [], True
                    for k in (short, long_):
                        _sync(device)
                        t = time.perf_counter()
                        F = prime_dual(Kx, Ky, dx=32, dy=32, epoch_pd=k,
                                       log_pd=k, verbose=True,
                                       state_dtype=st, device=device)
                        finite = finite and bool(torch.isfinite(F).all())
                        secs.append(time.perf_counter() - t)
                        del F
                    rec = rung.record(
                        **fields, finite=finite, run_seconds=secs,
                        seconds_per_iteration=(secs[1] - secs[0])
                        / (long_ - short))
                    rec['ok'] = finite
                except torch.cuda.OutOfMemoryError as e:
                    rec = rung.record(**fields, ok=False, error=repr(e)[:300])
                Kx = Ky = None
            rec['bytes_per_entry'] = (
                rec['max_memory_allocated'] / (n * n)
                if rec['max_memory_allocated'] is not None else None)
            _emit(records, rec, out)
            if not rec['ok']:
                break
    return records


# --------------------------------------------------------------------- fit
def _fit_fields(jm, fit_s):
    return dict(phase_timings=jm.phase_timings,
                mapping_timings={k: float(v) for k, v in
                                 jm._mapping_timings.items()},
                epochs_run=jm.epochs_run, fit_seconds=fit_s,
                meminfo=host_meminfo())


def _shape(size) -> tuple:
    """(N0, N1) of a rung: an int N is square, 'N0xN1' or a pair is not."""
    if isinstance(size, str):
        a, _, b = size.partition('x')
        return int(a), int(b or a)
    if isinstance(size, int):
        return size, size
    return int(size[0]), int(size[1])


def probe_fit(sizes: Sequence, state_dtype: str = 'auto',
              distance_mode: str = 'euclidean', epoch_pd: int = 6,
              log_pd: int = 3, epoch_DNN: int = 1,
              dims: Sequence[int] = (3000, 5000), pca_dim: int = 512,
              resident_gib: Optional[float] = None,
              device=None, out: Callable = _print) -> List[dict]:
    """Whole dense fits (no corr_landmarks; LANDMARK_AUTO_ENTRIES lifted)
    at each (N0, N1) of `sizes` (`_shape`) until the first out-of-memory
    rung; `epoch_pd` and `epoch_DNN` are cuts, `log_pd` < `epoch_pd` so the
    peak includes a log step. An unequal pair takes the first N0 RNA and N1
    ATAC rows of the generator. With `resident_gib` the residency budget is
    that many GiB and each modality is a dense wide matrix
    (`wide_matrix`) of as many features as its bf16 residency fits in it,
    so both residencies sit on the device beside the solve."""
    device = resolve_device(device)
    smi, records = smi_line(), []
    budget = (int(resident_gib * 1024 ** 3) if resident_gib is not None
              else residency.DEFAULT_BUDGET_BYTES)
    for size in sizes:
        n0, n1 = _shape(size)
        if resident_gib is None:
            data, _ = snare_like(max(n0, n1), *dims)
            data = [data[0][:n0], data[1][:n1]]
        else:
            data = [wide_matrix(n, budget // (2 * n), False, seed=seed,
                                device=device)
                    for n, seed in ((n0, 1), (n1, 2))]
        jm = est.JAMIE(device=device, distance_mode=distance_mode,
                       epoch_pd=epoch_pd, log_pd=log_pd, epoch_DNN=epoch_DNN,
                       min_epochs=epoch_DNN, use_early_stop=False,
                       pca_dim=(pca_dim, pca_dim), log_DNN=_NEVER,
                       solver_state_dtype=state_dtype)
        fields = dict(shape=[n0, n1], entries=n0 * n1,
                      dims=[int(d.shape[1]) for d in data],
                      distance_mode=distance_mode, epoch_pd=epoch_pd,
                      log_pd=log_pd, epoch_DNN=epoch_DNN,
                      resident_budget=budget,
                      state_dtype=jm._resolved_state_dtype(
                          est.dense_entries(n0, n1, 'float32')),
                      landmark_at_defaults=jm._takes_landmarks(
                          est.dense_entries(n0, n1, 'bfloat16')))
        with _Rung('fit', device, smi) as rung, \
                patched(DEFAULT_BUDGET_BYTES=budget), \
                timing.span('probes.fit') as taken:
            try:
                with mock.patch.object(est, 'LANDMARK_AUTO_ENTRIES', _NEVER):
                    t = time.perf_counter()
                    emb = jm.fit_transform(dataset=data)
                    fit_s = time.perf_counter() - t
                F = jm.match_result[0]
                dense = (isinstance(F, torch.Tensor) and not
                         isinstance(F, LowRankF)
                         and tuple(F.shape) == (n0, n1))
                finite = all(e.shape == (len(d), jm.config.output_dim)
                             and bool(np.isfinite(e).all())
                             for e, d in zip(emb, data))
                rec = rung.record(**fields, **_fit_fields(jm, fit_s),
                                  routes=_routes(taken),
                                  dense=dense, finite=finite,
                                  ok=dense and finite)
            except torch.cuda.OutOfMemoryError as e:
                rec = rung.record(**fields, ok=False, error=repr(e)[:300],
                                  routes=_routes(taken),
                                  meminfo=host_meminfo())
        residency.clear_residency_cache()
        jm = data = emb = F = None
        _emit(records, rec, out)
        if not rec['ok']:
            break
    return records


def probe_atlas(n: int, dims: Sequence[int] = (20000, 40000),
                density: float = 0.03, n_landmarks: int = 2048,
                epoch_pd: int = 2000, epoch_DNN: int = 10, pca_dim: int = 512,
                device=None, out: Callable = _print) -> List[dict]:
    """One landmark fit of the sparse multiome atlas at the default
    thresholds: the routes it took, its device and host peaks and its
    phase split."""
    device = resolve_device(device)
    smi, records = smi_line(), []
    (x0, x1), _ = latent_pair(n, dims, density, device=device)
    jm = est.JAMIE(device=device, corr_landmarks=n_landmarks,
                   pca_dim=(pca_dim, pca_dim), epoch_pd=epoch_pd,
                   epoch_DNN=epoch_DNN, min_epochs=epoch_DNN,
                   use_early_stop=False, log_DNN=_NEVER)
    fields = dict(n=n, dims=list(dims), density=density,
                  nnz=[int(x0.nnz), int(x1.nnz)], n_landmarks=n_landmarks,
                  epoch_pd=epoch_pd, epoch_DNN=epoch_DNN)
    with _Rung('atlas', device, smi) as rung, \
            timing.span('probes.atlas') as taken:
        try:
            t = time.perf_counter()
            emb = jm.fit_transform(dataset=[x0, x1])
            fit_s = time.perf_counter() - t
            finite = all(bool(np.isfinite(e).all()) for e in emb)
            rec = rung.record(**fields, **_fit_fields(jm, fit_s),
                              routes=_routes(taken),
                              finite=finite, ok=finite)
        except torch.cuda.OutOfMemoryError as e:
            rec = rung.record(**fields, ok=False, error=repr(e)[:300],
                              routes=_routes(taken))
    residency.clear_residency_cache()
    _emit(records, rec, out)
    return records


# --------------------------------------------------------------- residency
# Each arm forces one route family by patching the globals
_ARMS = {
    'exact': dict(_FEATURE_CHUNK_THRESHOLD=_NEVER, _STREAM_THRESHOLD=_NEVER,
                  BF16_LINK_ELEMS=_NEVER, _UPLOAD_ELEMS=_NEVER,
                  _FPS_BYTES_BUDGET=_NEVER, DEFAULT_BUDGET_BYTES=0),
    'resident_bf16': dict(_FEATURE_CHUNK_THRESHOLD=0, _STREAM_THRESHOLD=0,
                          BF16_LINK_ELEMS=0, DEFAULT_BUDGET_BYTES=_NEVER),
    'streamed': dict(_FEATURE_CHUNK_THRESHOLD=0, _STREAM_THRESHOLD=0,
                     BF16_LINK_ELEMS=0, _UPLOAD_ELEMS=0, _FPS_BYTES_BUDGET=0,
                     DEFAULT_BUDGET_BYTES=0),
}
_OWNERS = {'_FEATURE_CHUNK_THRESHOLD': distances,
           '_STREAM_THRESHOLD': preprocess, 'BF16_LINK_ELEMS': residency,
           'DEFAULT_BUDGET_BYTES': residency, '_UPLOAD_ELEMS': landmark,
           '_FPS_BYTES_BUDGET': landmark,
           '_SKETCH_SPMM_ROWS': preprocess,
           '_FOSCTTM_BLOCK_ENTRIES': evaluation}


@contextlib.contextmanager
def patched(**values):
    """The route globals set to `values` (by bare name) for the block."""
    with contextlib.ExitStack() as stack:
        for name, v in values.items():
            stack.enter_context(mock.patch.object(_OWNERS[name], name, v))
        yield


def _stage(rung_name, device, smi, fields, fn):
    """One timed call in its own window, with the routes it took."""
    with _Rung(rung_name, device, smi) as rung, \
            timing.span(f'probes.{rung_name}') as taken:
        try:
            fn()
            rec = rung.record(**fields, routes=_routes(taken))
        except torch.cuda.OutOfMemoryError as e:
            rec = rung.record(**fields, ok=False, error=repr(e)[:300],
                              routes=_routes(taken))
    residency.clear_residency_cache()
    return rec


def probe_residency(dense_shapes: Sequence = ((9190, 28930),),
                    csr_shapes: Sequence = ((9190, 241757),),
                    density: float = 0.05, pca_dim: int = 512,
                    n_landmarks: int = 2048,
                    sketch_rows: Sequence[int] = (16384, 65536),
                    foscttm_cells: int = 100_000,
                    foscttm_blocks: Sequence[int] = (1 << 26, 1 << 28,
                                                     1 << 30),
                    device=None, out: Callable = _print) -> List[dict]:
    """Each matrix through every route of the distances, the PCA fit, FPS
    and the landmark weights; then the SpMM sketch's block rows on each
    CSR and FOSCTTM's block size."""
    device = resolve_device(device)
    smi, records = smi_line(), []
    mats = [('dense', s) for s in dense_shapes] + [('csr', s)
                                                   for s in csr_shapes]
    for kind, (n, f) in mats:
        x = wide_matrix(n, f, kind == 'csr', density, device=device)
        base = dict(kind=kind, n=n, f=f, elems=n * f,
                    nnz=int(x.nnz) if kind == 'csr' else None)
        L = min(n_landmarks, n)
        lm_rows = np.sort(np.random.RandomState(0).choice(n, L,
                                                          replace=False))
        lms = x[lm_rows].toarray() if kind == 'csr' else x[lm_rows]
        stages = (
            ('distance', lambda: distances.dataset_distance_matrix(
                x, 'euclidean', device=device)),
            ('pca', lambda: preprocess.Preprocessor.fit(
                x, pca_dim=min(pca_dim, n, f), device=device)),
            ('fps', lambda: timing.note(route=landmark._pick_landmarks(
                x, L, 'fps', np.random.RandomState(0), device=device)[1])),
            ('weights', lambda: landmark._cell_to_landmark_weights(
                x, lms, 8, device=device)))
        for arm, values in _ARMS.items():
            with patched(**values):
                for stage, fn in stages:
                    _emit(records, _stage('residency', device, smi,
                                          dict(base, stage=stage, arm=arm),
                                          fn), out)
        if kind == 'csr':
            dc = residency.DeviceCSR(x, device)
            k = min(pca_dim + 10, f)
            M = torch.randn((f, k), device=device,
                            generator=torch.Generator(device=device
                                                      ).manual_seed(0))
            for rows in tuple(sketch_rows) + (n,):
                _emit(records, _stage(
                    'residency', device, smi,
                    dict(base, stage='sketch_block', arm=str(rows), k=k),
                    lambda: torch.cat([dc.matmul(M, s, s + rows)
                                       for s in range(0, n, rows)])), out)
            dc = M = None
        x = lms = None
    g = torch.Generator(device=device).manual_seed(0)
    emb = [torch.randn(foscttm_cells, 32, generator=g, device=device)
           .cpu().numpy() for _ in range(2)]
    for block in foscttm_blocks:
        with patched(_FOSCTTM_BLOCK_ENTRIES=block):
            _emit(records, _stage(
                'residency', device, smi,
                dict(kind='embedding', n=foscttm_cells, f=32,
                     stage='foscttm_block', arm=str(block)),
                lambda: evaluation.test_closer(emb, device=device)), out)
    return records


# ----------------------------------------------------------------- quality
def _quality_fit(data, labels, device, seed, **kw):
    jm = est.JAMIE(device=device, manual_seed=seed, use_early_stop=False,
                   log_DNN=_NEVER, **kw)
    t = time.perf_counter()
    emb = jm.fit_transform(dataset=data)
    secs = time.perf_counter() - t
    F = jm.match_result[0]
    return dict(foscttm=float(jm.test_closer(emb)),
                lta=float(jm.test_LabelTA(emb, [labels, labels])),
                seconds=secs, landmark=isinstance(F, LowRankF))


def probe_quality(seeds: int = 3, small: int = 1047,
                  latent_cells: int = 2000,
                  latent_dims: Sequence[int] = (2000, 4000),
                  epoch_DNN: int = 100, epoch_pd: int = 2000,
                  band_cells: int = 24000,
                  band_seeds: int = 2, band_epoch_pd: int = 300,
                  band_epoch_DNN: int = 20, dims: Sequence[int] = (3000, 5000),
                  device=None, out: Callable = _print) -> List[dict]:
    """FOSCTTM and LTA of each paired arm per seed (one record each), then
    one summary record per comparison: the mean and spread of each arm and
    the bf16 (or landmark) arm's mean less the f32 (or dense) arm's."""
    device = resolve_device(device)
    smi, records = smi_line(), []
    sets = {'snare': snare_like(small, *dims),
            'latent12': latent_pair(latent_cells, latent_dims, 0.03,
                                    device=device)}
    rounding = dict(_FEATURE_CHUNK_THRESHOLD=0, _STREAM_THRESHOLD=0,
                    BF16_LINK_ELEMS=0, DEFAULT_BUDGET_BYTES=_NEVER)
    comparisons = []
    for name, (data, labels) in sets.items():
        kw = dict(epoch_DNN=epoch_DNN, min_epochs=epoch_DNN,
                  epoch_pd=epoch_pd)
        comparisons.append((f'state/{name}', data, labels, range(seeds), (
            ('float32', {}, dict(kw, solver_state_dtype='float32')),
            ('bfloat16', {}, dict(kw, solver_state_dtype='bfloat16')))))
        comparisons.append((f'rounding/{name}', data, labels, range(seeds), (
            ('float32', {}, kw), ('bfloat16', rounding, kw))))
    band, band_labels = snare_like(band_cells, *dims)
    kw = dict(distance_mode='euclidean', epoch_pd=band_epoch_pd,
              epoch_DNN=band_epoch_DNN, min_epochs=band_epoch_DNN)
    comparisons.append(('landmark/snare_band', band, band_labels,
                        range(band_seeds), (
                            ('dense', dict(), kw),
                            ('landmark', dict(), dict(kw,
                                                      corr_landmarks=2048)))))
    for comp, data, labels, seed_range, arms in comparisons:
        per_arm = {}
        for arm, patches, kw in arms:
            for seed in seed_range:
                with _Rung('quality', device, smi) as rung, \
                        patched(**patches), \
                        mock.patch.object(est, 'LANDMARK_AUTO_ENTRIES',
                                          _NEVER):
                    res = _quality_fit(data, labels, device, seed, **kw)
                    residency.clear_residency_cache()
                    rec = rung.record(comparison=comp, arm=arm, seed=seed,
                                      n=int(data[0].shape[0]), **res)
                per_arm.setdefault(arm, []).append(rec)
                _emit(records, rec, out)
        (a, ra), (b, rb) = per_arm.items()
        summary = {'comparison': comp, 'arms': [a, b]}
        for metric in ('foscttm', 'lta'):
            va = np.array([r[metric] for r in ra])
            vb = np.array([r[metric] for r in rb])
            summary[metric] = {a: [float(va.mean()), float(va.std())],
                               b: [float(vb.mean()), float(vb.std())],
                               'delta': float(vb.mean() - va.mean())}
        with _Rung('quality', device, smi) as rung:
            _emit(records, rung.record(**summary), out)
    return records


# --------------------------------------------------------------------- CLI
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog='python -m jamie_tpu_torch.probes',
                                 description=__doc__.split('\n\n')[0])
    sub = ap.add_subparsers(dest='probe', required=True)
    s = sub.add_parser('solver')
    s.add_argument('--sizes', type=int, nargs='+',
                   default=[24000, 30000, 34000, 37000, 40000, 42000, 44000,
                            46000])
    s.add_argument('--state-dtypes', nargs='+',
                   default=['float32', 'bfloat16'])
    s = sub.add_parser('fit')
    s.add_argument('--sizes', nargs='+', default=[],
                   help='N (square) or N0xN1 per rung')
    s.add_argument('--state-dtype', default='auto')
    s.add_argument('--distance-mode', default='euclidean')
    s.add_argument('--epoch-dnn', type=int, default=1)
    s.add_argument('--resident', type=float, default=None, metavar='GIB',
                   help='residency budget in GiB; both modalities sized '
                        'to it (probe_fit)')
    s.add_argument('--atlas', type=int, default=None,
                   help='fit the sparse atlas at this many cells instead')
    s = sub.add_parser('residency')
    s.add_argument('--dense', type=int, nargs=2, action='append', default=[])
    s.add_argument('--csr', type=int, nargs=2, action='append', default=[])
    sub.add_parser('quality')
    args = ap.parse_args(argv)
    print(json.dumps({'route_thresholds': route_thresholds()}), flush=True)
    if args.probe == 'solver':
        probe_solver(args.sizes, args.state_dtypes)
    elif args.probe == 'fit' and args.atlas:
        probe_atlas(args.atlas, epoch_DNN=args.epoch_dnn)
    elif args.probe == 'fit':
        probe_fit(args.sizes, args.state_dtype, args.distance_mode,
                  epoch_DNN=args.epoch_dnn, resident_gib=args.resident)
    elif args.probe == 'residency':
        # the scGLUE pair (dense RNA, 0/1 CSR ATAC) unless shapes are given
        given = args.dense or args.csr
        probe_residency([tuple(s) for s in args.dense] if given
                        else ((9190, 28930),),
                        [tuple(s) for s in args.csr] if given
                        else ((9190, 241757),))
    else:
        probe_quality()


if __name__ == '__main__':
    main()
