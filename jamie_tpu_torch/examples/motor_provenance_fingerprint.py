"""scMNC-Motor gene-transform provenance via solver-telemetry fingerprint.

The counterpart of the repo's `examples/motor_provenance_fingerprint.py`.
The notebook's e-features and the rda's gene matrix are the same cells
the notebook used; only the gene CSV's normalization is unknown. But the
notebook printed the prime-dual telemetry (scMNC-Motor.ipynb cell 8):

    epoch:[500/2000]  err:0.3861 alpha:0.0050
    epoch:[1000/2000] err:3.3359 alpha:0.0249
    epoch:[1500/2000] err:5.7469 alpha:0.0598
    epoch:[2000/2000] err:7.0836 alpha:0.0926

err = ||a Kx - F Ky F^T||_F and alpha are deterministic functions of the
two distance matrices, so the 8 printed numbers fingerprint the unknown
transform. Each candidate transform is z-scored, its distance matrix
built (`--distance geodesic`, the default: the port's
`geodesic_distances(kmax=40)`, K3 and the host Dijkstra; `euclidean`: K3)
and the port's `prime_dual` replayed with `verbose=True`; its printed
lines are parsed and scored against `REF_TRACE`. The same candidates,
parse, score and printed lines as the example; sklearn's `scale` is
`_data.scale`, and `main` returns what it printed.

    python -m jamie_tpu_torch.examples.motor_provenance_fingerprint
        [--confirm NAME] [--precision default] [--distance geodesic]
        [--data-dir DIR] [--device cpu]
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re

import numpy as np

from ._data import parser, scale
from .scmnc_motor import DATA, RDA

REF_TRACE = {500: (0.3861, 0.0050), 1000: (3.3359, 0.0249),
             1500: (5.7469, 0.0598), 2000: (7.0836, 0.0926)}


def load_raw(data_dir: str = DATA):
    """(raw counts cells x genes, e-features cells x 29), float64."""
    from ..rdata import load_rda
    d = load_rda(os.path.join(data_dir, RDA))
    X = d['gdata']['matrix'].T.astype(np.float64)     # cells x genes, raw
    e = d['edata']
    efeat = [k for k in e if k != '__row_names__']
    E = np.stack([np.asarray(e[k], np.float64) for k in efeat], 1)
    return X, E


def candidates():
    """name -> transform(raw counts cells x genes) -> normalized matrix:
    the sweep's transforms plus scran-style size factors, Pearson residuals
    over a theta grid and a rank-quantile map."""

    def depth(X):
        return np.maximum(X.sum(1, keepdims=True), 1.0)

    def cpm(X, scale):
        return X / depth(X) * scale

    def pearson_residuals(X, theta):
        # analytic Pearson residuals (Lause/Berens/Kobak 2021; the
        # sctransform v2 approximation): mu = depth * gene_total / total,
        # r = (x - mu) / sqrt(mu + mu^2/theta), clipped at sqrt(n)
        d = X.sum(1, keepdims=True)
        g = X.sum(0, keepdims=True)
        mu = d * g / max(X.sum(), 1.0)
        r = (X - mu) / np.sqrt(mu + mu * mu / theta + 1e-12)
        n = X.shape[0]
        return np.clip(r, -np.sqrt(n), np.sqrt(n))

    def deseq_size_factors(X):
        # median-of-ratios (DESeq / scran-flavored) size factors
        logX = np.log(np.maximum(X, 1e-12))
        ok = (X > 0).all(0)
        if not ok.any():
            ok = (X > 0).mean(0) > 0.95
        loggeo = logX[:, ok].mean(0, keepdims=False)
        sf = np.exp(np.median(logX[:, ok] - loggeo[None, :], axis=1))
        sf = np.where(sf <= 0, 1.0, sf)
        return X / sf[:, None]

    def rank_quantile(X):
        # per-gene rank -> standard normal quantiles (ties by average rank)
        from scipy import stats
        out = np.empty_like(X)
        n = X.shape[0]
        for j in range(X.shape[1]):
            r = stats.rankdata(X[:, j], method='average')
            out[:, j] = stats.norm.ppf(r / (n + 1.0))
        return out

    med = lambda X: float(np.median(X.sum(1)))
    return {
        'raw': lambda X: X,
        'log1p_raw': np.log1p,
        'log2_raw': lambda X: np.log2(X + 1.0),
        'log10_raw': lambda X: np.log10(X + 1.0),
        'cpm1e4': lambda X: cpm(X, 1e4),
        'cpm1e4_log1p': lambda X: np.log1p(cpm(X, 1e4)),   # Seurat LogNormalize
        'cpm1e4_log2': lambda X: np.log2(cpm(X, 1e4) + 1.0),
        'cpm1e5_log1p': lambda X: np.log1p(cpm(X, 1e5)),
        'cpm1e6_log1p': lambda X: np.log1p(cpm(X, 1e6)),
        'cpm1e6_log2': lambda X: np.log2(cpm(X, 1e6) + 1.0),  # log2-CPM
        'cpm_median_log1p': lambda X: np.log1p(cpm(X, med(X))),  # scanpy
        'sqrt_cpm1e4': lambda X: np.sqrt(cpm(X, 1e4)),
        'deseq_sf_log1p': lambda X: np.log1p(deseq_size_factors(X)),
        'pearson_theta10': lambda X: pearson_residuals(X, 10.0),
        'pearson_theta100': lambda X: pearson_residuals(X, 100.0),
        'pearson_theta_inf': lambda X: pearson_residuals(X, 1e12),
        'rank_quantile': rank_quantile,
    }


def solver_trace(Kx, Ky, dx, dy, precision, device=None):
    """{epoch: (err, alpha)} as the port's prime_dual prints them over
    2000 iterations at log_pd=500."""
    from ..solvers.prime_dual import prime_dual
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        prime_dual(Kx, Ky, dx=dx, dy=dy, epoch_pd=2000, log_pd=500,
                   verbose=True, precision=precision, device=device)
    trace = {}
    for m in re.finditer(r'epoch:\[(\d+)/2000\] err:([0-9.]+) '
                         r'alpha:([0-9.]+)', buf.getvalue()):
        trace[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    return trace


def score(trace):
    """Max relative deviation from the reference telemetry over the 8
    printed numbers (4 errs + 4 alphas)."""
    devs = []
    for ep, (err_ref, al_ref) in REF_TRACE.items():
        if ep not in trace:
            return float('inf'), []
        err, al = trace[ep]
        devs.append(abs(err - err_ref) / max(err_ref, 1e-9))
        devs.append(abs(al - al_ref) / max(al_ref, 1e-9))
    return float(np.max(devs)), devs


def main(argv=None):
    """The zoo (or `--confirm NAME` alone, at 'highest' precision). Returns
    {'candidates': each candidate's printed line, 'ranking', 'ref_trace'}."""
    ap = parser(__doc__, DATA, quick=False, fits=False)
    ap.add_argument('--confirm', default=None,
                    help='single candidate at f32-exact matmul precision')
    ap.add_argument('--precision', default='default')
    ap.add_argument('--distance', default='geodesic',
                    choices=['geodesic', 'euclidean'],
                    help="geodesic is what the reference solver consumed "
                         "(the UnionCom-inherited distance_mode default; "
                         "the notebook's dist_method='euclidean' only "
                         "steers the DNN consistency loss)")
    args = ap.parse_args(argv)

    from ..core.dtypes import resolve_device
    from ..ops.distances import geodesic_distances, pairwise_distance
    device = resolve_device(args.device)

    def K_of(mat):
        if args.distance == 'geodesic':
            return geodesic_distances(mat.astype(np.float32), kmax=40,
                                      device=device)
        return pairwise_distance(mat, 'euclidean', device=device)

    X, E = load_raw(args.data_dir)
    E = scale(E)
    E[np.isnan(E)] = 0
    Ky = K_of(E)
    dx, dy = X.shape[1], E.shape[1]

    zoo = candidates()
    names = [args.confirm] if args.confirm else list(zoo)
    precision = 'highest' if args.confirm else args.precision

    results, lines = {}, []
    for name in names:
        Xt = scale(zoo[name](X.copy()))
        Xt[np.isnan(Xt)] = 0
        Kx = K_of(Xt)
        trace = solver_trace(Kx, Ky, dx, dy, precision, device=device)
        dev, devs = score(trace)
        results[name] = dev
        lines.append({'candidate': name, 'max_rel_dev': round(dev, 4),
                      'trace': {k: [round(v[0], 4), round(v[1], 4)]
                                for k, v in sorted(trace.items())}})
        print(json.dumps(lines[-1]), flush=True)

    ranked = sorted(results.items(), key=lambda kv: kv[1])
    record = {'ranking': [[n, round(d, 4)] for n, d in ranked],
              'ref_trace': {k: list(v) for k, v in REF_TRACE.items()}}
    print(json.dumps(record), flush=True)
    return {'candidates': lines, **record}


if __name__ == '__main__':
    main()
