"""How the port's device loops run and what a fit records of them, on the
CPU: the one switch (`core/graphs.plain_loops`, read through
`graphs.captures`) that the loop runners and the trainer's epochs follow,
and the fit's span tree as the one record of the routes and loop steps
(`core/timing.routes`)."""

import collections
import contextlib
import threading

import numpy as np
import pytest
import torch
from scipy import sparse

from jamie_tpu_torch import JAMIE, preprocess
from jamie_tpu_torch.config import JamieConfig
from jamie_tpu_torch.core import graphs, residency, timing
from jamie_tpu_torch.models import CoupledVAE
from jamie_tpu_torch.ops import distances
from jamie_tpu_torch.solvers import landmark
from jamie_tpu_torch.train import trainer as T

CUDA = torch.device('cuda')


def test_captures_follows_the_switch():
    """A CUDA device captures outside the switch and not inside it; the
    rule comes back after a nested exit and after an exception; the CPU
    never captures; the switch holds for its own thread only."""
    assert graphs.captures(CUDA) and graphs.captures('cuda:0')
    assert not graphs.captures('cpu')
    with graphs.plain_loops():
        assert not graphs.captures(CUDA)
        with graphs.plain_loops():
            assert not graphs.captures(CUDA)
        assert not graphs.captures(CUDA)
        seen = []
        other = threading.Thread(
            target=lambda: seen.append(graphs.captures(CUDA)))
        other.start()
        other.join()
        assert seen == [True]
    assert graphs.captures(CUDA)
    with pytest.raises(ValueError):
        with graphs.plain_loops():
            raise ValueError('inside the switch')
    assert graphs.captures(CUDA) and not graphs.captures('cpu')


@pytest.mark.parametrize('mesh', [False, True])
def test_steps_runner_follows_the_switch(mesh):
    """The runner `steps_runner` picks for a CUDA device object, built
    without a launch: a `StepGraph` outside the switch (on one device; a
    mesh's would first check NCCL), the step op by op inside it, on the
    'eager' or 'mesh' route; the CPU's is op by op either way."""
    def step():
        pass
    if not mesh:
        runner = graphs.steps_runner('loop', step, CUDA)
        assert type(runner) is graphs.StepGraph
        assert (runner.route, runner.graph) == ('captured', None)
    with graphs.plain_loops():
        runner = graphs.steps_runner('loop', step, CUDA, mesh=mesh)
        assert type(runner) is graphs.EagerSteps
        assert runner.route == ('mesh' if mesh else 'eager')
    for switch in (False, True):
        with (graphs.plain_loops() if switch
              else contextlib.nullcontext()):
            runner = graphs.steps_runner('loop', step, 'cpu', mesh=mesh)
        assert type(runner) is graphs.EagerSteps
        assert runner.route == ('mesh' if mesh else 'cpu')


def test_epoch_runner_follows_the_switch(monkeypatch):
    """The trainer's epoch runner for a CUDA device, from the same
    predicate: the captured epochs outside the switch (a stand-in that
    records its construction, so nothing launches), the eager body inside
    it, on the 'eager' route; a CPU trainer's is the eager body."""
    built = []

    class Captured:
        route = 'captured'

        def __init__(self, trainer):
            built.append(trainer)
    monkeypatch.setattr(T, '_CapturedEpochs', Captured)
    rng = np.random.RandomState(0)
    data = [rng.randn(40, d).astype(np.float32) for d in (6, 4)]
    cfg = JamieConfig(batch_size=16, epoch_DNN=2)
    tr = T.JamieTrainer(cfg, CoupledVAE((6, 4), 3), data, 'identity',
                        'zeros', device='cpu')
    assert type(tr._epoch_runner()) is T._EagerEpochs
    tr.device = CUDA
    runner = tr._epoch_runner()
    assert type(runner) is Captured and built == [tr]
    with graphs.plain_loops():
        runner = tr._epoch_runner()
    assert type(runner) is T._EagerEpochs and runner.route == 'eager'
    assert built == [tr]


def _count(routes, names):
    return {k: v for k, v in routes.items() if k in names and v}


# The route names each call site writes: distances, PCA fit and transform,
# landmark selection and weights
ROUTES = ('distance_resident_bf16', 'distance_feature_chunked',
          'pca_randomized', 'pca_direct', 'pca_resident_bf16',
          'pca_streamed', 'pca_row_streamed', 'pca_transform_spmm',
          'pca_transform_uploader', 'fps_dense', 'fps_jl_sketch', 'uniform',
          'weights_spmm', 'weights_uploader', 'weights_dense')


def _pair(n=120, f0=60, f1=80, seed=2):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 4).astype(np.float32)
    z[: n // 2] += 3.0
    return [np.maximum(z @ rng.randn(4, f) - 0.9, 0).astype(np.float32)
            for f in (f0, f1)]


CASES = {
    # both modalities past the patched thresholds: the bf16 residency for
    # the distances and the PCA
    'dense_resident': dict(
        csr=False, kw={}, patch={'_FEATURE_CHUNK_THRESHOLD': 1000,
                                 '_STREAM_THRESHOLD': 1000},
        want={'distance_resident_bf16': 2, 'pca_resident_bf16': 2}),
    # under every threshold: K3 and the exact PCA
    'dense_exact': dict(csr=False, kw={}, patch={},
                        want={'pca_direct': 2}),
    # CSR landmark fit: RNA resident (14,400 bf16 bytes), ATAC (19,200)
    # over the budget and row-streamed, FPS on the JL sketch, weights by
    # SpMM
    'landmark_csr': dict(
        csr=True, kw=dict(corr_landmarks=16),
        patch={'_STREAM_THRESHOLD': 1000, 'BF16_LINK_ELEMS': 1000,
               'DEFAULT_BUDGET_BYTES': 16_000, '_FPS_BYTES_BUDGET': 1000},
        want={'fps_jl_sketch': 2, 'weights_spmm': 2,
              'pca_resident_bf16': 1, 'pca_row_streamed': 1}),
}
_OWNERS = {'_FEATURE_CHUNK_THRESHOLD': distances,
           '_STREAM_THRESHOLD': preprocess, 'BF16_LINK_ELEMS': residency,
           'DEFAULT_BUDGET_BYTES': residency, '_FPS_BYTES_BUDGET': landmark}


@pytest.mark.parametrize('case', sorted(CASES))
def test_fit_spans_hold_every_route_and_loop_count(monkeypatch, case):
    """A CPU fit's span tree, through `timing.routes`, holds each route
    its call sites took and the steps every device loop ran by route (each
    runner's `run` counted on its own beside it), and the trainer's
    epochs that ran, as the loop 'epochs' on the 'eager' route."""
    spec = CASES[case]
    for name, v in spec['patch'].items():
        monkeypatch.setattr(_OWNERS[name], name, v)
    ran = collections.Counter()
    real = graphs.EagerSteps.run

    def run(self, k):
        ran[f'{self.name}/{self.route}'] += k
        real(self, k)
    monkeypatch.setattr(graphs.EagerSteps, 'run', run)
    data = _pair()
    if spec['csr']:
        data = [sparse.csr_matrix(x) for x in data]
    residency.clear_residency_cache()
    jm = JAMIE(device='cpu', pca_dim=(10, 10), batch_size=32, epoch_DNN=4,
               min_epochs=2, use_early_stop=False, epoch_pd=30,
               log_DNN=10_000, **spec['kw'])
    jm.fit_transform(dataset=data)
    residency.clear_residency_cache()
    routes = timing.routes(jm.trace)
    assert _count(routes, ROUTES) == spec['want']
    loops = {k: v for k, v in routes.items() if '/' in k}
    assert loops == {**ran, 'epochs/eager': jm.epochs_run}
    assert ran['prime_dual/cpu'] == 30 and jm.epochs_run == 4
    if spec['kw']:
        assert ran['fps/cpu'] == 2 * (16 - 1)
