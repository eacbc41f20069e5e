"""The JAMIE estimator — the public scikit-learn-style API, on PyTorch.

Reference parity: `jamie_tpu/estimator.py` (class `JAMIE`, itself
jamie/jamie.py:29-972). Same surface: `fit_transform(dataset, P)`,
`compute_distances`, `match`, `Prime_Dual`, `com_corr`, `project_jamie`,
`modal_predict`, `transform`, `transform_one`, `test_closer`,
`test_LabelTA`, `test_label_dist`, `Visualize`, `save_model`,
`load_model`.

`JAMIE(device=...)` picks the device; with none given it runs on the CUDA
card and raises when there is none (`device='cpu'` is the explicit CPU
route). Past the dense solver's range the estimator takes jamie_tpu's
large-dataset route: landmark F (`corr_landmarks`, or automatically past
`LANDMARK_AUTO_ENTRIES`), the implicit 'identity'/'zeros' P/F sentinels past
`SENTINEL_ENTRIES`, and sparse or 1-D mask priors and `f_top_k`. Modalities
may be dense arrays or scipy-sparse matrices (normalized to CSR once): the
distance, PCA and landmark phases take jamie_tpu's sparse and bf16
residency routes (`core/residency.py`), whose device copies are released
after preprocessing, before training claims device memory. The legacy
modes run as in jamie_tpu: `project_mode='tsne'` (Hungarian pairs from F,
then the pair-aligned t-SNE, `solvers/tsne.py`), the t-SNE/UMAP preclass
(`model_pca`, `preprocess.NonlinearEmbedding`) and `corr_method='jamie'`
(`solvers/lowrank.py`). The fit takes `compute_dtype='bfloat16'`
(bf16 activations, f32 parameters), mid-fit snapshots (`checkpoint_dir`,
`checkpoint_every`; resume through `trainer.restore_fit_state` and
`trainer.fit(state=...)`) and a per-chunk `metrics_path` log.

A device mesh (`JAMIE(mesh=...)`, a `core.mesh` DeviceMesh; jamie_tpu's
estimator.py:80-96) is SPMD: every rank builds the estimator and calls
`fit_transform` with the same inputs, and every rank gets the same result.
It engages by itself when `torch.distributed` is initialized with more than
one rank (from `mesh_shape` / `mesh_axis_names`, all ranks on 'data' by
default); `use_mesh=False` turns that off. The mesh reaches the phases
jamie_tpu shards: the distances, the prime-dual and landmark solves and the
trainer (data and tensor parallelism). The phases it does not shard (PCA,
the host geodesic graph, serving) run on every rank, and rank 0 broadcasts
what feeds a sharded phase (the distance matrices, the preprocessed
inputs), so ranks cannot diverge. Rank 0 alone prints; `save_model` writes
from rank 0 (every rank calls it) a checkpoint that loads on one device.

A second `fit_transform` on one estimator reuses the first fit's P and F
(`self.P`, `self.match_result`), as jamie_tpu does; on data with other row
counts the trainer raises ValueError where jamie_tpu would train on the top
left block of the stale P and F (a deliberate deviation).
"""

from __future__ import annotations

import contextlib
import tracemalloc
import warnings
from itertools import product
from typing import Optional, Sequence

import numpy as np
import torch

from ._meta import __version__
from .config import config_from_kwargs
from .core import mesh as cm
from .core.dtypes import resolve_device
from .core.hostmat import densify, ensure_row_major, is_scipy_sparse
from .core.residency import clear_residency_cache
from .core import timing
from .models.convert import load_flax_variables, to_flax_variables
from .models.coupled_vae import CoupledVAE
from .ops.distances import dataset_distance_matrix
from .ops.lowrank import LowRankF
from .ops.sparse import SparseRows, is_sparse_input
from .persistence import load_checkpoint, save_checkpoint
from .preprocess import PCA, Preprocessor
from .solvers.assignment import hungarian_pairs
from .solvers.landmark import landmark_correspondence
from .solvers.lowrank import lowrank_corr
from .solvers.prime_dual import prime_dual
from .solvers.tsne import joint_probabilities, project_tsne
from .train.trainer import JamieTrainer

# The route thresholds of jamie_tpu (estimator.py:41-59), with the values
# the probes measured on one H100 80GB HBM3 at 700.00 W
# (`python -m jamie_tpu_torch.probes`, PERF.md). Module globals read at
# call time, so tests can patch them to force either route.
# Past this many N0*N1 entries P and an all-zeros F stay implicit (the
# 'identity' / 'zeros' sentinels, a zero-nnz SparseRows for unequal rows).
# jamie_tpu's value, kept: no ceiling, the sentinels are exact and a dense
# P or F this large is only zeros and ones.
SENTINEL_ENTRIES = 50_000_000
# The two dense thresholds below were measured on square fits; an unequal
# pair is compared by `dense_entries`, the square fit of the same peak.
# Dense prime-dual state: exact f32 up to this many entries, bf16 M1 /
# carried products above ('auto', estimator.py:50). 83% (jamie_tpu's
# margin) of the largest f32-state fit the `fit` probe ran: 32,000^2 =
# 1.024G entries at 82.3 GB (80.4 B per entry; 33,000^2 ran out).
DENSE_F32_STATE_ENTRIES = 850_000_000
# Past this many entries the correspondence takes the landmark route
# (corr_landmarks forces it at any size). 83% of the largest default
# (bf16-state) fit the `fit` probe ran: 33,000^2 = 1.089G entries at 78.8
# GB (34,000^2 ran out). Below 2^31, so K1's int32 offsets always hold.
LANDMARK_AUTO_ENTRIES = 900_000_000
# Peak device bytes of a dense fit, in tenths of a byte per entry of its
# (N0, N1), (N0, N0) and (N1, N1) arrays (the distances, Kx and the log
# step's residual are (N0, N0); Ky and `inner` are (N1, N1)), by state
# dtype: the least-squares fit to the `fit` probe's square rungs and its
# 2:1, 1:2 and 3:1 rungs at 400M entries, each within 1.6% (H100 80GB
# HBM3, 700.00 W). By N0 * N1 alone, 2:1, 1:2 and 3:1 pairs at 850M
# (f32) and a 2:1 pair at 900M (bf16) entries ran out of memory.
DENSE_PEAK_TENTHS = {'float32': (341, 268, 196),
                     'bfloat16': (233, 266, 225)}


def dense_entries(n0: int, n1: int, state_dtype: str) -> int:
    """The entries N^2 of the square dense fit whose peak (by
    DENSE_PEAK_TENTHS[state_dtype]) equals an (n0, n1) fit's: N0 * N1 for
    a square pair, more for a skewed one."""
    a, b, c = DENSE_PEAK_TENTHS[state_dtype]
    return -(-(a * n0 * n1 + b * n0 * n0 + c * n1 * n1) // (a + b + c))


def _compute_dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


def _unwrap_anndata(dataset):
    """AnnData unwrap (jamie/jamie.py:147-149), duck-typed on `.X`+`.obs`."""
    if dataset and all(hasattr(d, 'X') and hasattr(d, 'obs')
                       for d in dataset):
        return [d.X for d in dataset], dataset
    return dataset, None


class JAMIE:
    """Joint variational autoencoders for multimodal imputation & embedding,
    on PyTorch. Accepts the reference's kwargs; see `JamieConfig`."""

    def __init__(self, match_result=None, mesh=None,
                 use_mesh: Optional[bool] = None, device=None, **kwargs):
        cm.check_mesh(mesh)
        self.device = resolve_device(device)
        self.P = kwargs.pop('P', None)
        self.config = config_from_kwargs(**kwargs)
        self.match_result = match_result
        # use_mesh=None (default) shards by itself whenever the process
        # group has more than one rank; use_mesh=False runs unsharded
        if (mesh is None and use_mesh is not False
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            mesh = cm.create_mesh(self.config.mesh_shape,
                                  self.config.mesh_axis_names)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f'a {mesh.device_type} mesh cannot run on '
                             f'{self.device}')
        self.mesh = mesh
        self.model: Optional[CoupledVAE] = None
        self.preprocessors: Optional[Sequence[Preprocessor]] = None
        self.dataset_num = 2
        self.loss_history = {}
        self.dist = None
        self._use_landmarks = False
        self.trainer: Optional[JamieTrainer] = None
        # the root span of the last fit (`core/timing`)
        self.trace: Optional[timing.Span] = None

    # ------------------------------------------------------------------ fit
    def fit_transform(self, dataset=None, P=None):
        """Full pipeline: distances -> correspondence F -> coupled-VAE
        training -> integrated embeddings (jamie/jamie.py:113-222).
        The fit's spans are `self.trace` (`core/timing`): its phases, and
        under them where the work happens."""
        with cm.rank0_stdout(), timing.span('fit', fit=True) as root:
            self.trace = root
            return self._fit_transform(dataset, P)

    @contextlib.contextmanager
    def _phase(self, name: str):
        """An estimator phase: a span that waits for the card before it
        closes; with `enable_memory_logging`, tracemalloc's (current, peak)
        of the phase is kept on it and the trace restarts."""
        with timing.span(name, sync=True) as sp:
            yield sp
        if self.config.enable_memory_logging:
            sp.set(host_memory=tracemalloc.get_traced_memory())
            tracemalloc.stop()
            tracemalloc.start()

    def _report(self, phases) -> None:
        print('-' * 33)
        print('JAMIE Done!')
        timing.print_phases(phases)
        if self.config.enable_memory_logging:
            tracemalloc.stop()

    def _shared(self, x):
        """Rank 0's x on every rank of the mesh (x itself without one)."""
        return x if self.mesh is None else cm.broadcast_from_rank0(x,
                                                                    self.mesh)

    def _fit_transform(self, dataset, P):
        cfg = self.config
        if P is not None:
            self.P = P

        if cfg.enable_memory_logging:
            tracemalloc.start()
        with self._phase('Distance') as distance:
            np.random.seed(cfg.manual_seed)

            self.dataset, self.dataset_annotation = _unwrap_anndata(dataset)
            # Never copied or written (the residency caches key on
            # identity); scipy-sparse modalities stay sparse, as CSR for the
            # row-streamed device routes
            self.dataset = [ensure_row_major(d) if is_scipy_sparse(d)
                            else d if isinstance(d, np.ndarray)
                            else np.asarray(d) for d in self.dataset]
            self.dataset_num = len(self.dataset)
            assert self.dataset_num == 2, (
                'Currently only compatible with 2 modalities.')
            self.row = [int(np.shape(d)[0]) for d in self.dataset]
            self.col = [int(np.shape(d)[1]) for d in self.dataset]
            entries = self.row[0] * self.row[1]

            # Landmark route: the dense N x N distance matrices exist only
            # to feed the dense solver; the landmark solver builds its own
            # L x L ones (jamie_tpu/estimator.py:144-156)
            self._use_landmarks = self._takes_landmarks(
                dense_entries(*self.row, 'bfloat16'))
            # the t-SNE projection reads the distances whatever F's route
            self.compute_distances(save_dist=(
                cfg.project_mode == 'tsne'
                or (self.match_result is None and cfg.use_f_tilde
                    and not self._use_landmarks)))

        with self._phase('Correspondence') as correspondence:
            if not cfg.use_f_tilde:
                # Past SENTINEL_ENTRIES the zero matrix stays implicit
                self.match_result = (
                    ['zeros'] if entries > SENTINEL_ENTRIES else
                    [np.zeros([d.shape[0] for d in self.dataset],
                              np.float32)])
            if self.match_result is None:
                self.match_result = self.match()
            if self.device.type == 'cuda':
                # The solve's freed temporaries stay reserved by the caching
                # allocator; cuSOLVER and cuBLAS allocate their handles and
                # workspaces outside it (a dense 37,464 x 18,732 fit failed
                # in cusolverDnCreate at its first QR without this)
                with timing.span('estimator.empty_cache'):
                    torch.cuda.empty_cache()
            if cfg.project_mode == 'tsne':
                self._tsne_pairs()
        if cfg.project_mode == 'tsne':
            with self._phase('Mapping') as mapping:
                integrated_data = self._project_tsne()
            self._report((distance, correspondence, mapping))
            return integrated_data

        with self._phase('Mapping') as mapping:
            match_matrix = [[None for _ in range(self.dataset_num)]
                            for _ in range(self.dataset_num)]
            k = 0
            for i, j in product(*(2 * [range(self.dataset_num)])):
                if i < j:   # project_jamie reads only the upper slot W[0][1]
                    match_matrix[i][j] = self.match_result[k]
                    k += 1
            integrated_data = self.project_jamie(match_matrix)

        phases = (distance, correspondence, mapping)
        self._report(phases)
        self.phase_timings = {sp.name: round(sp.seconds, 3) for sp in phases}
        print()
        return integrated_data

    def _tsne_pairs(self):
        """The legacy UnionCom route's correspondence (jamie_tpu/
        estimator.py:168-223, jamie/jamie.py:175-195): the Hungarian pairs
        of each F."""
        self.pairs_x, self.pairs_y = [], []
        for i in range(self.dataset_num - 1):
            mat = self.match_result[i]
            if isinstance(mat, str):
                # the all-zeros sentinel: the assignment of a zero cost
                # matrix is the leading diagonal, never materialized
                k = min(self.row[i], self.row[i + 1])
                self.pairs_x.append(np.arange(k))
                self.pairs_y.append(np.arange(k))
                continue
            if isinstance(mat, (SparseRows, LowRankF)):
                mat = mat.to_dense()   # the assignment needs the dense cost
            row_ind, col_ind = hungarian_pairs(mat)
            self.pairs_x.append(row_ind)
            self.pairs_y.append(col_ind)

    def _project_tsne(self):
        """The legacy UnionCom route's mapping: PCA-50 of each modality
        wider than 50 columns, the joint probabilities of each distance
        matrix and the pair-aligned t-SNE. Returns [Y1, Y2]; phase_timings
        is not set, as in jamie_tpu."""
        cfg = self.config
        P_joint = [joint_probabilities(self.dist[i], cfg.perplexity,
                                       device=self.device)
                   for i in range(self.dataset_num)]
        for i in range(self.dataset_num):
            if self.col[i] > 50:
                self.dataset[i] = PCA(n_components=50, device=self.device
                                      ).fit_transform(self.dataset[i])
                self.col[i] = 50
            elif is_scipy_sparse(self.dataset[i]):
                self.dataset[i] = densify(self.dataset[i])
        return project_tsne(
            self.dataset, P_joint, self.pairs_x[0], self.pairs_y[0],
            output_dim=cfg.output_dim, n_iters=cfg.tsne_iters,
            align_weight=cfg.tsne_align_weight, lr=cfg.tsne_lr,
            exaggeration=cfg.tsne_exaggeration, device=self.device)

    # ------------------------------------------------------------ distances
    def compute_distances(self, save_dist: bool = True):
        """Per-dataset distance matrices (jamie/jamie.py:839-890)."""
        cfg = self.config
        if save_dist:
            self.dist = []
        print('Shape of Raw data')
        for i in range(self.dataset_num):
            print('Dataset {}:'.format(i), np.shape(self.dataset[i]))
            if save_dist:
                self.dist.append(self._shared(dataset_distance_matrix(
                    self.dataset[i], cfg.distance_mode, kmax=cfg.kmax,
                    device=self.device, mesh=self.mesh)))

    # -------------------------------------------------------- correspondence
    def match(self):
        """Find correspondence between multi-omics datasets
        (jamie/jamie.py:224-250)."""
        print('Device:', self.device.type)
        cor_pairs = []
        for i in range(self.dataset_num):
            for j in range(i + 1, self.dataset_num):
                print('-' * 33)
                print(f'Find correspondence between Dataset {i + 1} '
                      f'and Dataset {j + 1}')
                if self._use_landmarks:
                    cor_pairs.append(self._landmark_correspondence(i, j))
                elif self.config.corr_method == 'unioncom':
                    cor_pairs.append(self.Prime_Dual(
                        [self.dist[i], self.dist[j]],
                        dx=self.col[i], dy=self.col[j]))
                else:
                    warnings.warn(
                        'Correlation method `jamie` is currently a WIP, and '
                        'does not produce reliable results')
                    cor_pairs.append(self.com_corr(
                        [self.dist[i], self.dist[j]]))
        print('Finished Matching!')
        return cor_pairs

    def _landmark_correspondence(self, i: int, j: int):
        """Low-rank F between datasets i and j (jamie_tpu/estimator.py:
        283-301); the L x L solver state is small, so 'auto' state is f32."""
        cfg = self.config
        return landmark_correspondence(
            self.dataset[i], self.dataset[j],
            n_landmarks=cfg.corr_landmarks or 2048,
            k_interp=cfg.corr_landmark_k,
            selection=cfg.corr_landmark_selection,
            factor_layout=cfg.corr_factor_layout,
            distance_mode=cfg.distance_mode, kmax=cfg.kmax,
            seed=cfg.manual_seed, device=self.device, mesh=self.mesh,
            epoch_pd=cfg.epoch_pd, rho=cfg.rho, epsilon=cfg.epsilon,
            delay=cfg.delay, log_pd=cfg.log_pd,
            precision=('highest' if cfg.solver_dtype == 'float32'
                       else 'default'),
            state_dtype=(cfg.solver_state_dtype
                         if cfg.solver_state_dtype != 'auto' else 'float32'))

    def _takes_landmarks(self, entries: int) -> bool:
        """Whether F takes the landmark route: corr_landmarks, or past
        LANDMARK_AUTO_ENTRIES (`dense_entries` with bf16 state, the state
        past DENSE_F32_STATE_ENTRIES) when F is still to be solved."""
        cfg = self.config
        return (cfg.use_f_tilde and self.match_result is None
                and (cfg.corr_landmarks is not None
                     or entries > LANDMARK_AUTO_ENTRIES))

    def _resolved_state_dtype(self, entries: int) -> str:
        """'auto' -> exact f32 state up to DENSE_F32_STATE_ENTRIES
        (`dense_entries` with f32 state), bf16 state above
        (jamie_tpu/estimator.py:315-326)."""
        st = self.config.solver_state_dtype
        if st != 'auto':
            return st
        return ('float32' if entries <= DENSE_F32_STATE_ENTRIES
                else 'bfloat16')

    def Prime_Dual(self, dist, dx=None, dy=None, verbose=True):
        cfg = self.config
        entries = dense_entries(int(np.shape(dist[0])[0]),
                                int(np.shape(dist[1])[0]), 'float32')
        return prime_dual(
            dist[0], dist[1], dx=dx, dy=dy,
            epoch_pd=cfg.epoch_pd, rho=cfg.rho, epsilon=cfg.epsilon,
            delay=cfg.delay, log_pd=cfg.log_pd, verbose=verbose,
            precision=('highest' if cfg.solver_dtype == 'float32'
                       else 'default'),
            state_dtype=self._resolved_state_dtype(entries),
            device=self.device, mesh=self.mesh)

    def com_corr(self, dist):
        """Experimental low-rank correspondence (jamie/jamie.py:252-312),
        kept for API parity; the reference warns it is unreliable."""
        return lowrank_corr(dist[0], dist[1], device=self.device)

    # ------------------------------------------------------------- training
    def project_jamie(self, W):
        """Train the coupled VAE and return integrated embeddings
        (jamie/jamie.py:416-804)."""
        cfg = self.config
        print('-' * 33)
        print('Train coupled autoencoders')
        assert len(W) == 2, 'Currently only compatible with 2 modalities.'
        implicit = self.row[0] * self.row[1] > SENTINEL_ENTRIES
        if self.P is None:
            # P defaults (jamie_tpu/estimator.py:356-371): past
            # SENTINEL_ENTRIES the identity stays implicit, and an unaligned
            # pair gets a zero-nnz SparseRows (the 'zeros' regime)
            if self.row[0] == self.row[1]:
                self.P = ('identity' if implicit
                          else np.eye(self.row[0], dtype=np.float32))
            elif implicit:
                self.P = SparseRows.from_coo(
                    [], [], [], (self.row[0], self.row[1]))
            else:
                self.P = np.zeros((self.row[0], self.row[1]), np.float32)
        if not (isinstance(self.P, (str, torch.Tensor))
                or is_sparse_input(self.P)):
            self.P = np.asarray(self.P, np.float32)
        # F passes through in its form: sentinel, sparse, low-rank, or the
        # solver's device tensor (:374-386)
        self.F = W[0][1]
        if (cfg.f_top_k is not None
                and isinstance(self.F, (np.ndarray, torch.Tensor))
                and self.F.ndim == 2):
            # top-k compression bounds the trainer's F at O(N k)
            self.F = SparseRows.top_k(self.F, cfg.f_top_k)

        pca_dims = cfg.pca_dim if cfg.pca_dim is not None else (None, None)
        with timing.span('Preprocessing', sync=True) as preprocessing:
            pres, transformed = [], []
            for dim, data in zip(pca_dims, self.dataset):
                with timing.span('preprocess.fit', method=(
                        cfg.model_pca if dim is not None else 'standardize')):
                    pres.append(Preprocessor.fit(
                        data, pca_dim=dim, method=cfg.model_pca,
                        device=self.device, power_iters=cfg.pca_power_iters))
                    # the cached fit sample: no second projection of the
                    # raw matrix
                    transformed.append(self._shared(pres[-1].transform_fit()))
            self.preprocessors = tuple(pres)
            # the distance/PCA residencies release their device memory
            clear_residency_cache()
        self.col = [int(x.shape[1]) for x in transformed]

        with timing.span('Trainer setup', sync=True) as setup:
            self.model = CoupledVAE(
                input_dim=tuple(self.col), output_dim=cfg.output_dim,
                dropout=cfg.dropout,
                matmul_bf16=cfg.model_matmul_dtype == 'bfloat16',
                seed=cfg.manual_seed,
                compute_dtype=_compute_dtype(cfg.compute_dtype == 'bfloat16'))
            self.trainer = JamieTrainer(cfg, self.model, transformed, self.P,
                                        self.F, device=self.device,
                                        mesh=self.mesh)
        with timing.span('Training', sync=True) as training:
            self.train_state = self.trainer.fit(
                checkpoint_dir=cfg.checkpoint_dir,
                checkpoint_every=cfg.checkpoint_every,
                metrics_path=cfg.metrics_path)
        with timing.span('Output', sync=True) as output:
            self.loss_history = self.trainer.loss_history
            self.epochs_run = self.trainer.epochs_run
            self.fit_seconds = self.trainer.fit_seconds
            self.sampling_method = self.trainer.sampling_method
            integrated_data = self.trainer.final_embed()
        print('Finished Mapping!')
        phases = (preprocessing, setup, training, output)
        if cfg.debug:
            timing.print_phases(phases)
        self._mapping_timings = {sp.name: sp.seconds for sp in phases}
        return integrated_data

    # ------------------------------------------------------------ inference
    def _require_model(self):
        assert self.model is not None, (
            'Model must be trained before modal prediction.')
        self.model.eval()

    def _to_device(self, data) -> torch.Tensor:
        return torch.as_tensor(np.asarray(data, np.float32),
                               device=self.device)

    @torch.no_grad()
    def modal_predict(self, data, modality: int,
                      pre_transformed: bool = False):
        """Cross-modal imputation (jamie/jamie.py:806-815)."""
        self._require_model()
        to_modality = (modality + 1) % self.dataset_num
        if not pre_transformed:
            data = self.preprocessors[modality].transform(data)
        decoded = self.model.impute(self._to_device(data), modality,
                                    to_modality)
        return np.asarray(self.preprocessors[to_modality].inverse_transform(
            decoded.float().cpu().numpy()))

    def transform(self, dataset, corr=None, pre_transformed: bool = False):
        """Re-embed both modalities with a trained model
        (jamie/jamie.py:817-829): the eval-mode mu heads, which is what the
        reference's full forward returns as output[0]; `corr` is accepted
        for signature parity and never influences the result."""
        del corr
        return [self.transform_one(dataset[i], i, pre_transformed)
                for i in range(len(dataset))]

    @torch.no_grad()
    def transform_one(self, data, i: int, pre_transformed: bool = False):
        """Single-modality embedding via the mu head (jamie/jamie.py:831-837)."""
        self._require_model()
        if not pre_transformed:
            data = self.preprocessors[i].transform(data)
        return self.model.embed_one(self._to_device(data),
                                    i).float().cpu().numpy()

    # -------------------------------------------------------------- metrics
    def test_closer(self, integrated_data, distance_metric=None):
        """FOSCTTM, both directions (jamie/jamie.py:892-915)."""
        from .evaluation import test_closer
        return test_closer(integrated_data, distance_metric=distance_metric,
                           device=self.device)

    def test_label_dist(self, integrated_data, datatype,
                        distance_metric=None, verbose=True):
        """Inter-label centroid distances (jamie/jamie.py:917-941)."""
        from .evaluation import test_label_dist
        return test_label_dist(integrated_data, datatype,
                               distance_metric=distance_metric,
                               verbose=verbose, device=self.device)

    def test_LabelTA(self, integrated_data, datatype, k=None,
                     return_k: bool = False):
        """Label-transfer accuracy via kNN (jamie/jamie.py:943-961)."""
        from .evaluation import knn_label_transfer_accuracy
        acc, k = knn_label_transfer_accuracy(integrated_data, datatype, k=k,
                                             device=self.device)
        if return_k:
            return acc, k
        return acc

    def Visualize(self, data, integrated_data, datatype=None, mode=None):
        """In-class API for the visualization function
        (jamie/jamie.py:963-965), its embeddings on this estimator's
        device."""
        from .utils import uc_visualize
        uc_visualize(data, integrated_data, datatype=datatype, mode=mode,
                     device=self.device)

    # ---------------------------------------------------------- persistence
    def save_model(self, f):
        """Array-based checkpoint in jamie_tpu's npz layout. After a mesh
        fit every rank calls it: a tensor-parallel model is gathered whole,
        and rank 0 writes."""
        model = self.model
        if self.trainer is not None and self.trainer.tp_specs:
            whole = self.trainer.whole_state_dict()
            model = CoupledVAE(model.input_dim, model.output_dim,
                               dropout=model.dropout,
                               matmul_bf16=model.matmul_bf16,
                               compute_dtype=model.compute_dtype)
            model.load_state_dict(whole)
        if not cm.is_rank0():
            return
        header = {
            'version': __version__,
            'input_dim': list(self.model.input_dim),
            'output_dim': self.model.output_dim,
            'dropout': self.model.dropout,
            'num_modalities': self.dataset_num,
            'matmul_bf16': bool(self.model.matmul_bf16),
            'compute_bf16': self.model.compute_dtype == torch.bfloat16,
        }
        params, batch_stats = to_flax_variables(model)
        save_checkpoint(f, params, batch_stats, self.preprocessors, header)

    def load_model(self, f):
        """Restore a checkpoint written by either package."""
        params, batch_stats, pres, header = load_checkpoint(
            f, device=self.device)
        self.preprocessors = pres
        self.dataset_num = int(header['num_modalities'])
        self.model = CoupledVAE(
            input_dim=tuple(header['input_dim']),
            output_dim=int(header['output_dim']),
            dropout=header['dropout'],
            matmul_bf16=bool(header.get('matmul_bf16', False)),
            compute_dtype=_compute_dtype(header.get('compute_bf16', False)))
        load_flax_variables(self.model, params, batch_stats)
        self.model.to(self.device).eval()
        return self
