"""On the card: the kernel names the roofline readers look for are the
ones a fit's trace holds, and K3's launch count is the one its reader
takes for a self distance a modality. Skips without a CUDA card."""

import pytest
import torch

import manifest
import run
import tracing
from conftest import tiny
from roofline import k1, k3


@pytest.mark.cuda
def test_trace_names_k1_and_k3(bench):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cfg = tiny(manifest.config(bench, 'scmnc_visual'), n=600)
    harness = manifest.harness(cfg)
    host, _ = harness.make_host(cfg, 1, torch.device('cuda', 0))
    kw = run.fit_kwargs(cfg, manifest.traffic('geodesic'), 1)
    with tracing.TracedFit() as traced:
        rec = run.one_fit(host, kw, torch.device('cuda', 0), harness, cfg,
                          keep=False)
    summary = tracing.summarize(traced.prof)
    assert summary['device_events'] > 0
    assert tracing.kernel_time(summary, k1.KERNELS)[1] == kw['epoch_pd']
    assert tracing.kernel_time(summary, k3.KERNELS)[1] >= 2
    assert rec['launches'][k3.WRAPPER] == len(cfg['shapes'])
    assert rec['solver_state_dtype'] == 'float32'
    assert rec['solve_shape'] == [600, 600]
    assert 0 < summary['busy_s'] < summary['window_s']
