"""The repo's examples, on this package.

One module for each example of the repo's `examples/` that the port runs,
under the same name, so a reader finds each counterpart. The synthetic-data
examples:

- `sample`: the README's walkthrough (fit, integrate, impute, save, plot)
  on `make_branching_pair`;
- `tuning`: the loss-weight random search of `utils.tune_cm`;
- `imputation_comparison`: JAMIE's cross-modal imputation against the kNN
  and simple-NN baselines on a held-out split (and, with `--scgem`, on the
  scGEM data);
- `atlas_scale`: the 100,000-cell PCA-space trainer, and with
  `--sparse-data` raw CSR modalities through `JAMIE` with a landmark F.

The paper's reproduction pipelines on the published datasets, read from
`--data-dir` (default: the repository's examples/data tree, in the
layout the JAX examples read; the data is not there yet):

- `scgem`: the scGEM notebook (priors, imputation split, multi-seed and
  ablation runs); `comparison`: JAMIE against the five baselines on it;
- `scmnc_motor`, `scmnc_motor_sweep` and `motor_provenance_fingerprint`:
  the scMNC motor cortex fit, its normalization sweep and its
  solver-telemetry fingerprint;
- `scmnc_visual`: the scMNC visual cortex fit;
- `scglue`: the scGLUE fit (`load_scglue` reads the `.h5ad` files, `run`
  fits arrays).

Each runs as `python -m jamie_tpu_torch.examples.<name>` with the
example's arguments and defaults, on the CUDA card unless `device='cpu'`
(`--device cpu`) is passed. Each keeps its own copy of what it needs of
the example (data generators with bit-equal draws, the loaders, the
metrics) and imports nothing of jax, `jamie_tpu`, `examples/`, sklearn or
pandas (`_data` holds sklearn's `preprocessing.scale` and a CSV reader).
"""
