"""Configuration for the PyTorch JAMIE estimator.

The same frozen dataclass as `jamie_tpu.config` (same fields, defaults,
validation and `cache_key`), so a config and its cache key mean the same
thing in both packages.

`prng_impl` only steers the TPU build and is accepted and inert here (the
port draws from its own torch generators). `mesh_shape`,
`mesh_axis_names` and `tp_wide_threshold` shape the device mesh
(`core/mesh.py`) as in jamie_tpu. `epoch_chunk` and `dispatch_lookahead`
mean what they mean in jamie_tpu: the trainer dispatches `epoch_chunk`
epochs at a time (on the card as replays of captured CUDA graphs),
reads each chunk's losses once, and keeps `dispatch_lookahead`
chunks in flight past the one it reads; a chunk is also the step of the
`metrics_path` log and of `checkpoint_every`; on a device mesh as on one
device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from typing import Any, Optional, Sequence, Tuple

DISTANCE_MODES = (
    # Pairwise (sklearn-compatible metric names; jamie/jamie.py:117-127)
    'euclidean', 'l2', 'l1', 'manhattan', 'cityblock', 'braycurtis',
    'canberra', 'chebyshev', 'correlation', 'cosine', 'dice', 'hamming',
    'jaccard', 'kulsinski', 'mahalanobis', 'matching', 'minkowski',
    'rogerstanimoto', 'russellrao', 'seuclidean', 'sokalmichener',
    'sokalsneath', 'sqeuclidean', 'yule', 'wminkowski', 'nan_euclidean',
    'haversine',
    # Non-pairwise
    'geodesic', 'spearman', 'pearson',
)

SAMPLING_METHODS = ('diag', 'hybrid', 'zeros')


@dataclasses.dataclass(frozen=True)
class JamieConfig:
    """All knobs of the JAMIE fit, with reference defaults.

    Fields mirror the reference constructor (jamie/jamie.py:38-62) plus the
    inherited UnionCom params the JAMIE path reads.
    """

    # --- Model / projection (jamie/jamie.py:38-62) ---
    output_dim: int = 32
    pca_dim: Optional[Tuple[Optional[int], ...]] = (512, 512)
    model_pca: str = 'pca'            # 'pca' | 'umap' | 'tsne'
    pca_power_iters: int = 1          # bf16-resident, row-streamed PCA
    dropout: Optional[float] = None   # None -> 0.6 if max(dim) > 64 else 0
    dist_method: str = 'euclidean'    # similarity used in the cosine loss term
    PF_Ratio: Optional[float] = None  # None -> 1.0 (jamie/jamie.py:517)
    loss_weights: Optional[Tuple[float, ...]] = None

    # --- Training loop (jamie/jamie.py:48-62,98-109) ---
    model_lr: float = 1e-3
    epoch_DNN: int = 10000
    batch_size: int = 512
    batch_step: bool = True
    min_epochs: int = 2500
    min_increment: float = 1e-8
    max_steps_without_increment: int = 500
    use_early_stop: bool = True
    log_DNN: int = 500
    log_debug: int = 100
    debug: bool = False
    record_loss: bool = True

    # --- Correspondence solver (UnionCom-inherited; jamie/jamie.py:314-414) ---
    use_f_tilde: bool = True
    corr_method: str = 'unioncom'     # 'unioncom' | 'jamie' (experimental)
    epoch_pd: int = 2000              # the pinned unioncom 0.4.0 default
    epsilon: float = 0.001            # prime-dual step size
    rho: float = 10.0                 # augmented-lagrangian penalty
    delay: int = 0                    # iterations before scale factor updates
    log_pd: int = 500
    corr_landmarks: Optional[int] = None     # landmark F with L landmarks
    corr_landmark_k: int = 8
    corr_landmark_selection: str = 'fps'
    corr_factor_layout: str = 'auto'

    # --- Distances (jamie/jamie.py:839-890) ---
    distance_mode: str = 'geodesic'   # UnionCom-inherited default
    kmax: int = 40                    # geodesic kNN cap
    perplexity: float = 30.0          # legacy tsne path
    tsne_iters: int = 1000
    tsne_align_weight: float = 10.0
    tsne_lr: float = 0.5
    tsne_exaggeration: float = 12.0

    # --- Misc ---
    manual_seed: int = 666
    integration_type: str = 'MultiOmics'
    project_mode: str = 'jamie'
    in_place: bool = False
    enable_memory_logging: bool = False

    # --- Numerics and device knobs ---
    compute_dtype: str = 'float32'        # 'float32' | 'bfloat16' activations
    # Model matmuls only in bf16 operands with an f32 result
    model_matmul_dtype: str = 'float32'   # 'float32' | 'bfloat16'
    # Prime-dual matmuls: 'bfloat16' = bf16 operands, f32 result;
    # 'float32' = exact f32 (TF32 off)
    solver_dtype: str = 'bfloat16'
    # Prime-dual state storage: 'bfloat16' keeps M1, the carried products
    # and the K operands in bf16 (F and M2 stay f32); 'auto' = f32 up to
    # estimator.DENSE_F32_STATE_ENTRIES
    solver_state_dtype: str = 'auto'
    epoch_chunk: int = 100            # epochs per dispatched chunk
    # Chunks kept in flight past the one being read back: the host reads
    # chunk k's (tiny) loss outputs while the card already runs
    # k+1..k+1+L. Post-stop epochs are no-ops on the card (a conditional
    # node), so the <= L chunks dispatched after an early stop cost ~0.
    # 0 = fully sequential (also forced whenever checkpoint_every is set,
    # because mid-fit snapshots need the state at the processed boundary).
    dispatch_lookahead: int = 3
    mesh_shape: Optional[Tuple[int, ...]] = None   # None -> all ranks on 'data'
    mesh_axis_names: Tuple[str, ...] = ('data',)
    true_ratio: float = 0.8           # hybrid-sampling corr fraction (jamie.py:529)
    f_top_k: Optional[int] = None     # SparseRows top-k F
    # Tensor parallelism: parameter dims >= this (and divisible by the
    # 'model' mesh axis) shard over it (core/mesh.py param_spec)
    tp_wide_threshold: int = 1024
    prng_impl: Optional[str] = None   # inert (jax PRNG implementation)
    checkpoint_dir: Optional[str] = None   # mid-fit snapshots
    checkpoint_every: int = 0
    metrics_path: Optional[str] = None     # per-chunk JSONL

    def __post_init__(self):
        if self.integration_type != 'MultiOmics':
            raise ValueError("integration_type error! Enter MultiOmics.")
        if self.distance_mode not in DISTANCE_MODES:
            raise ValueError('distance_mode error! Enter a correct distance_mode.')
        if self.project_mode not in ('jamie', 'tsne'):
            raise ValueError("Choose correct project_mode: 'jamie', 'tsne'.")
        if self.model_pca not in ('pca', 'umap', 'tsne'):
            raise ValueError("model_pca must be one of 'pca', 'umap', 'tsne'.")
        if self.corr_method not in ('unioncom', 'jamie'):
            raise ValueError("corr_method must be 'unioncom' or 'jamie'.")
        # Normalize sequences to tuples so the config hashes canonically
        if self.loss_weights is not None and not isinstance(self.loss_weights, tuple):
            object.__setattr__(self, 'loss_weights', tuple(self.loss_weights))
        if self.pca_dim is not None and not isinstance(self.pca_dim, tuple):
            object.__setattr__(self, 'pca_dim', tuple(self.pca_dim))

    def replace(self, **kw) -> 'JamieConfig':
        return dataclasses.replace(self, **kw)

    # --- canonical hashing (reference: hash_kwargs, jamie/utilities.py:610-636) ---
    def nondefault_kwargs(self) -> dict:
        """Dict of fields that differ from the defaults."""
        default = JamieConfig()
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v != getattr(default, f.name):
                out[f.name] = v
        return out

    def cache_key(self, dataset_name: str, shapes: Sequence[Tuple[int, int]]) -> str:
        """Canonical string for cache filenames, like the reference's hash_kwargs."""
        size_str = '---'.join(
            [dataset_name] + ['-'.join(str(s) for s in shape) for shape in shapes])
        kw = {k: v for k, v in sorted(self.nondefault_kwargs().items())
              if k not in ('enable_memory_logging', 'debug', 'record_loss',
                           'checkpoint_dir', 'checkpoint_every',
                           'metrics_path')}
        if not kw:
            return size_str
        blob = json.dumps(kw, sort_keys=True, default=str)
        digest = hashlib.sha1(blob.encode()).hexdigest()[:10]
        return f'{size_str}---{digest}'


# UnionCom constructor params the reference accepted but the JAMIE path never
# reads (jamie/jamie.py:111 forwards **kwargs to uc.UnionCom.__init__); they
# pass through without a warning for drop-in compatibility.
_INERT_REFERENCE_KWARGS = frozenset((
    'epoch_pd1', 'beta', 'usePercent', 'col', 'row', 'test', 'gpu_number',
))


def config_from_kwargs(**kwargs: Any) -> JamieConfig:
    """Build a config from loose reference-style kwargs.

    Unknown kwargs warn instead of raising (the reference silently forwarded
    them to UnionCom); `lr` is the reference alias for `model_lr`.
    """
    field_names = {f.name for f in dataclasses.fields(JamieConfig)}
    known = {k: v for k, v in kwargs.items() if k in field_names}
    if 'lr' in kwargs and 'model_lr' not in kwargs:
        known['model_lr'] = kwargs['lr']
    elif 'lr' in kwargs and kwargs['lr'] != kwargs['model_lr']:
        warnings.warn(
            f"Both lr={kwargs['lr']} and model_lr={kwargs['model_lr']} "
            'given; lr is the reference alias for model_lr and is ignored '
            'when both are present.', UserWarning, stacklevel=3)
    unknown = sorted(k for k in kwargs
                     if k not in field_names and k != 'lr'
                     and k not in _INERT_REFERENCE_KWARGS)
    if unknown:
        warnings.warn(
            f'Ignoring unknown JAMIE kwargs: {unknown} — not a JamieConfig '
            'field (check for typos; see jamie_tpu_torch.config.JamieConfig).',
            UserWarning, stacklevel=3)
    return JamieConfig(**known)
