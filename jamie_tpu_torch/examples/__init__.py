"""The repo's synthetic-data examples, on this package.

One module for each example of the repo's `examples/` that needs no data
from outside the repository, under the same name, so a reader finds each
counterpart:

- `sample`: the README's walkthrough (fit, integrate, impute, save, plot)
  on `make_branching_pair`;
- `tuning`: the loss-weight random search of `utils.tune_cm`;
- `imputation_comparison`: JAMIE's cross-modal imputation against the kNN
  and simple-NN baselines on a held-out split;
- `atlas_scale`: the 100,000-cell PCA-space trainer, and with
  `--sparse-data` raw CSR modalities through `JAMIE` with a landmark F.

Each runs as `python -m jamie_tpu_torch.examples.<name>` with the example's
arguments and defaults, on the CUDA card unless `device='cpu'` is passed
to its `main`. Each keeps its own copy of the example's data generator
(bit-equal draws) and imports nothing of jax, `jamie_tpu` or `examples/`.
"""
