"""scMNC-Motor normalization-provenance sweep.

The counterpart of the repo's `examples/scmnc_motor_sweep.py`. The
notebook read a normalized gene CSV that is not shipped; the rda holds raw
counts, so the CSV's row transform is the one unknown behind the
full-prior LTA gap. The sweep fits every standard single-cell transform,
each followed by the loader's per-gene z-score (which absorbs any per-gene
affine difference, so candidates differ only through per-cell depth
handling and the log/sqrt pseudocount placement). The candidates are the
port's `normalize` functions, which `tests/test_torch_normalize.py` holds
to the example's inline copies. The same names, fits, seeds and table
keys; `--data-dir`, `--device` (default: the CUDA card) and the epoch
cuts are the twin's.

    python -m jamie_tpu_torch.examples.scmnc_motor_sweep [--seeds 2]
        [--only name,...] [--data-dir DIR] [--device cpu]
        [--epoch-dnn N --min-epochs N]
"""

from __future__ import annotations

import json
import time

import numpy as np

from .. import normalize as nz
from ._data import cuts_of, parser
from .scmnc_motor import DATA, KWARGS, load_scmnc_motor

CANDIDATES = {
    # round-2 coverage, kept for the table
    'raw': lambda x: x,
    'log1p': nz.log1p,
    'logcpm_1e4': lambda x: nz.log1p(nz.cpm(x, 1e4)),
    # pseudocount-placement variants (z-score can't absorb these)
    'logcpm_1e2': lambda x: nz.log1p(nz.cpm(x, 1e2)),
    'logcpm_1e5': lambda x: nz.log1p(nz.cpm(x, 1e5)),
    'logcpm_1e6': lambda x: nz.log1p(nz.cpm(x, 1e6)),
    'logcpm_median': lambda x: nz.log1p(nz.normalize_total(x)),
    # non-log depth handling
    'cpm_1e4': lambda x: nz.cpm(x, 1e4),
    'sqrt_cpm_1e4': lambda x: nz.sqrt(nz.cpm(x, 1e4)),
    # size-factor families
    'deseq_log': nz.normalize_deseq,
    'pearson_resid': nz.pearson_residuals,
    # the remaining standard bulk/SC normalizations
    'tmm_log': nz.normalize_tmm,
    'uq_log': nz.normalize_upper_quartile,
    'quantile_log': nz.normalize_quantile,
}


def main(argv=None):
    """The sweep; returns what it prints last ({'sweep', 'reference'})."""
    ap = parser(__doc__, DATA, quick=False)
    ap.add_argument('--seeds', type=int, default=2)
    ap.add_argument('--only', type=str, default=None)
    args = ap.parse_args(argv)
    names = (args.only.split(',') if args.only else list(CANDIDATES))

    from .. import JAMIE
    from ..core.dtypes import resolve_device
    device = resolve_device(args.device)
    cuts = cuts_of(args)

    table = {}
    for name in names:
        dataset, types = load_scmnc_motor(normalize=CANDIDATES[name],
                                          data_dir=args.data_dir)
        ltas, foscttms = [], []
        t0 = time.perf_counter()
        for seed in range(args.seeds):
            np.random.seed(seed)
            jm = JAMIE(manual_seed=seed, log_pd=10_000, device=device, **{
                **KWARGS, 'log_DNN': 100_000, **cuts})
            jm.fit_transform(dataset=dataset)
            emb = jm.transform(dataset=dataset)
            foscttms.append(float(jm.test_closer(emb)))
            ltas.append(float(jm.test_LabelTA(emb, types)))
        table[name] = {
            'lta_mean': round(float(np.mean(ltas)), 4),
            'lta_sd': round(float(np.std(ltas)), 4),
            'foscttm_mean': round(float(np.mean(foscttms)), 5),
            'seconds': round(time.perf_counter() - t0, 1),
            'runs': [round(v, 4) for v in ltas],
        }
        print(json.dumps({name: table[name]}), flush=True)
    print()
    record = {'sweep': table, 'reference': {'lta': 0.8957, 'foscttm': 0.0025}}
    print(json.dumps(record, indent=1))
    return record


if __name__ == '__main__':
    main()
