"""Comparison-method harness on real scGEM: JAMIE vs the paper baselines.

The counterpart of the repo's `examples/comparison.py`, which mirrors the
reference notebooks' comparison cells (scGEM.ipynb cells 14-18, accuracy
table in cell 25): the same JAMIE fit, `compare_methods` with every
baseline and the same method kwargs, the same record keys and
`REFERENCE`. `cuts` is set over the JAMIE fit's kwargs (a smoke run's
epoch cuts); the baselines keep theirs.

  Algorithm     JAMIE      NLMA       LMA       CCA    MMD-MA  UnionCom
  FOSCTTM    0.006799  0.000048  0.102222  0.093715  0.193447  0.212567
  LTA        0.887006  0.875706  0.689266  0.768362  0.531073  0.604520

    python -m jamie_tpu_torch.examples.comparison [--quick]
        [--data-dir DIR] [--device cpu] [--epoch-dnn N --min-epochs N]
"""

from __future__ import annotations

import json
import time

import numpy as np

from ._data import cuts_of, parser
from .scgem import DATA, load_scgem

REFERENCE = {
    'JAMIE': {'foscttm': 0.006799, 'lta': 0.887006},
    'NLMA': {'foscttm': 0.000048, 'lta': 0.875706},
    'LMA': {'foscttm': 0.102222, 'lta': 0.689266},
    'CCA': {'foscttm': 0.093715, 'lta': 0.768362},
    'MMD-MA': {'foscttm': 0.193447, 'lta': 0.531073},
    'UnionCom': {'foscttm': 0.212567, 'lta': 0.604520},
}


def main(quick=False, data_dir: str = DATA, device=None,
         cuts: dict = None):
    from .. import JAMIE
    from ..compare import compare_methods
    from ..core.dtypes import resolve_device
    device = resolve_device(device)

    np.random.seed(42)
    dataset, labels = load_scgem(data_dir)
    results = {}

    t0 = time.perf_counter()
    jm = JAMIE(**{**dict(output_dim=32, epoch_DNN=3000 if quick else 10000,
                         min_epochs=1000 if quick else 2500, batch_size=128,
                         pca_dim=None, log_DNN=1000, epoch_chunk=500),
                  **(cuts or {})}, device=device)
    emb = jm.fit_transform(dataset=dataset)
    results['JAMIE'] = {'foscttm': round(jm.test_closer(emb), 5),
                        'lta': round(jm.test_LabelTA(emb, labels), 4),
                        'seconds': round(time.perf_counter() - t0, 1)}

    t0 = time.perf_counter()
    baselines = compare_methods(
        dataset, labels,
        methods=('NLMA', 'LMA', 'CCA', 'MMD-MA', 'UnionCom'),
        output_dim=32,
        method_kwargs={
            'MMD-MA': {'n_iters': 2001 if quick else 10001},
            'UnionCom': {'epoch_pd': 500 if quick else 20000,
                         'epoch_DNN': 100, 'log_pd': 100_000},
        }, device=device)
    for name, entry in baselines.items():
        results[name] = {k: round(v, 5) for k, v in entry.items()
                         if k != 'embeddings'}
    results['baseline_seconds'] = round(time.perf_counter() - t0, 1)
    results['reference'] = REFERENCE
    print(json.dumps(results, indent=2))
    return results


if __name__ == '__main__':
    args = parser(__doc__, DATA).parse_args()
    main(quick=args.quick, data_dir=args.data_dir, device=args.device,
         cuts=cuts_of(args))
