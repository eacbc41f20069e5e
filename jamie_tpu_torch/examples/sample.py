"""The README's walkthrough on synthetic branching data: fit -> integrate
-> impute -> save -> plot (the reference's sample.ipynb shape).

The counterpart of the repo's `examples/sample.py`: the same
`make_branching_pair` draws, the same `JAMIE` settings and the same steps.
The checkpoint and the figure go to `out_dir` (by default a
`jamie_tpu_torch_sample` directory in the temporary directory), never to
the JAX example's paths. The figure is drawn where matplotlib is
installed. `main` returns what it printed.

    python -m jamie_tpu_torch.examples.sample [--out-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, Optional

import numpy as np


def make_branching_pair(n=300, seed=42):
    """MMD-MA-style two-branch trajectory observed in two modalities."""
    rng = np.random.RandomState(seed)
    t = rng.rand(n)
    branch = rng.rand(n) > 0.5
    z = np.stack([t, t ** 2, np.where(branch, t, -t),
                  np.where(branch, 1.0, -1.0),
                  np.sin(3 * t), np.cos(3 * t)], axis=1)
    z += 0.05 * rng.randn(n, 6)
    x1 = z @ rng.randn(6, 2000) + 0.1 * rng.randn(n, 2000)
    x2 = z @ rng.randn(6, 1000) + 0.1 * rng.randn(n, 1000)
    labels = np.where(branch, 'branch-a', 'branch-b')
    return ([x1.astype(np.float32), x2.astype(np.float32)],
            [labels, labels])


def default_out_dir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), f'jamie_tpu_torch_{name}')


def main(out_dir: Optional[str] = None, device=None, n: int = 300,
         epoch_DNN: int = 2000, min_epochs: int = 500, epoch_pd: int = 500,
         on_fit: Optional[Callable] = None) -> dict:
    """The walkthrough; n and the epochs cut it to size (the defaults are
    the example's). on_fit(jm, integrated, dataset) runs right after the
    fit, before the metrics."""
    from ..core.dtypes import resolve_device
    from ..estimator import JAMIE

    device = resolve_device(device)   # before any work
    out_dir = out_dir or default_out_dir('sample')
    os.makedirs(out_dir, exist_ok=True)
    dataset, types = make_branching_pair(n)
    jm = JAMIE(min_epochs=min_epochs, epoch_DNN=epoch_DNN, epoch_pd=epoch_pd,
               batch_size=128, pca_dim=(64, 64), distance_mode='euclidean',
               device=device)
    integrated = jm.fit_transform(dataset=dataset)
    if on_fit is not None:
        on_fit(jm, integrated, dataset)

    foscttm = jm.test_closer(integrated)
    acc = jm.test_LabelTA(integrated, types)
    print('label transfer accuracy:', acc)

    imputed = jm.modal_predict(dataset[0], 0)
    r = np.nanmean([np.corrcoef(imputed[:, j], dataset[1][:, j])[0, 1]
                    for j in range(dataset[1].shape[1])])
    print('mean imputation r:', round(float(r), 3))

    model_path = os.path.join(out_dir, 'jamie_sample_model.npz')
    jm.save_model(model_path)
    print('saved to', model_path)

    figure = None
    try:
        import matplotlib
    except ImportError as e:
        print('plotting skipped:', e)
    else:
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        from ..evaluation import plot_integrated
        plt.figure(figsize=(10, 4))
        plot_integrated(integrated, types, names=['Modality 1', 'Modality 2'],
                        method='pca', legend=True, device=device)
        figure = os.path.join(out_dir, 'jamie_sample_integrated.png')
        plt.savefig(figure, dpi=100)
        plt.close('all')
        print('figure saved to', figure)
    return {'foscttm': float(foscttm), 'label_transfer_accuracy': float(acc),
            'mean_imputation_r': float(r), 'model_path': model_path,
            'figure': figure}


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out-dir', default=None)
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the host (default: the CUDA card)")
    args = ap.parse_args()
    main(out_dir=args.out_dir, device=args.device)
