"""Loss-weight tuning by random search (the reference's
scMNC-Visual-Tuning.ipynb driving utilities.tune_cm,
jamie/utilities.py:485-503).

The counterpart of the repo's `examples/tuning.py`: the same data
(`make_branching_pair(n=200)`), `JAMIE` settings and `tune_cm(jm, dataset,
types, wt_size=4, num_search=5)`. The weights are drawn from numpy's global
generator, unseeded, as in the example. Every search fit after the first
reuses the first one's correspondence F, as `JAMIE` does on a refit of the
same rows (in both packages).

    python -m jamie_tpu_torch.examples.tuning [--num-search N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .sample import make_branching_pair


def main(num_search: int = 5, device=None, n: int = 200,
         epoch_DNN: int = 800, min_epochs: int = 200,
         epoch_pd: int = 300) -> dict:
    """The search; n and the epochs cut it to size (the defaults are the
    example's)."""
    from ..core.dtypes import resolve_device
    from ..estimator import JAMIE
    from ..utils import tune_cm

    device = resolve_device(device)   # before any work
    dataset, types = make_branching_pair(n=n)
    types = [np.unique(t, return_inverse=True)[1] for t in types]
    jm = JAMIE(epoch_DNN=epoch_DNN, min_epochs=min_epochs, epoch_pd=epoch_pd,
               batch_size=64, pca_dim=(32, 32), use_early_stop=False,
               log_DNN=100000, device=device)
    best_wt, best_data = tune_cm(jm, dataset, types, wt_size=4,
                                 num_search=num_search)
    print('best weights:', best_wt)
    return {'best_weights': None if best_wt is None else
            [float(w) for w in best_wt],
            'best_embedding_shapes': None if best_data is None else
            [list(e.shape) for e in best_data],
            'best_finite': best_data is not None and all(
                bool(np.isfinite(e).all()) for e in best_data)}


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--num-search', type=int, default=5)
    ap.add_argument('--epoch-dnn', type=int, default=800)
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the host (default: the CUDA card)")
    args = ap.parse_args()
    main(num_search=args.num_search, epoch_DNN=args.epoch_dnn,
         device=args.device)
