"""The threshold probes (jamie_tpu_torch/probes.py) at tiny ladders on the
CPU: each returns one record per rung with every field, the device fields
None off the card; a rung that runs out of device memory ends its ladder
as not passed. The numbers they measure come only from a run on the card
(`python -m jamie_tpu_torch.probes ...`)."""

import numpy as np
import pytest
import torch

from jamie_tpu_torch import probes

COMMON = ('probe', 'smi', 'max_memory_allocated', 'mem_get_info',
          'host_peak_rss', 'host_peak_scope', 'seconds', 'ok')


def _check(records, probe, *fields):
    assert records
    for r in records:
        assert r['probe'] == probe
        for k in COMMON + fields:
            assert k in r, k
        assert r['max_memory_allocated'] is None      # the CPU
        assert r['mem_get_info'] is None
        assert r['host_peak_rss'] > 0 and r['seconds'] >= 0


def test_solver_probe():
    recs = probes.probe_solver([16, 24], device='cpu', out=lambda s: None)
    _check(recs, 'solver', 'n', 'entries', 'state_dtype', 'iters',
           'state_bytes', 'finite', 'run_seconds', 'seconds_per_iteration',
           'bytes_per_entry')
    assert [(r['state_dtype'], r['n']) for r in recs] == [
        ('float32', 16), ('float32', 24), ('bfloat16', 16), ('bfloat16', 24)]
    assert all(r['ok'] and r['finite'] for r in recs)
    assert recs[0]['state_bytes'] == 36 * 16 * 16


def test_solver_probe_stops_at_out_of_memory(monkeypatch):
    """An out-of-memory rung is reported as not passed and ends the
    ladder of its state dtype; the next dtype starts again."""
    real = probes.prime_dual

    def pd(Kx, *a, **k):
        if Kx.shape[0] in (24, 32):    # not the 256-row warm-up
            raise torch.cuda.OutOfMemoryError('CUDA out of memory (test)')
        return real(Kx, *a, **k)
    monkeypatch.setattr(probes, 'prime_dual', pd)
    recs = probes.probe_solver([16, 24, 32], device='cpu',
                               out=lambda s: None)
    assert [(r['n'], r['ok']) for r in recs] == [
        (16, True), (24, False), (16, True), (24, False)]
    assert 'out of memory' in recs[1]['error']


def test_fit_probe_takes_the_dense_route():
    recs = probes.probe_fit([40, '48x36'], dims=(20, 30), pca_dim=6,
                            device='cpu', out=lambda s: None)
    _check(recs, 'fit', 'shape', 'entries', 'state_dtype', 'dense',
           'finite', 'phase_timings', 'mapping_timings', 'fit_seconds',
           'meminfo', 'landmark_at_defaults', 'routes', 'resident_budget')
    assert [r['shape'] for r in recs] == [[40, 40], [48, 36]]
    assert [r['entries'] for r in recs] == [1600, 48 * 36]
    assert all(r['ok'] and r['dense'] for r in recs)
    assert set(recs[0]['phase_timings']) >= {'Distance', 'Correspondence',
                                             'Mapping'}


def test_fit_probe_sizes_inputs_to_the_residency_budget():
    """`resident_gib`: each modality has as many features as its bf16
    residency fits in the budget, and (past the thresholds, lowered here)
    both stay resident for the distances and the PCA."""
    budget = 2 * 40 * 25
    with probes.patched(_FEATURE_CHUNK_THRESHOLD=0, _STREAM_THRESHOLD=0):
        recs = probes.probe_fit(['40x32'], pca_dim=6,
                                resident_gib=budget / 1024 ** 3,
                                device='cpu', out=lambda s: None)
    (r,) = recs
    assert r['ok'] and r['resident_budget'] == budget
    assert r['dims'] == [25, budget // (2 * 32)]
    assert r['routes']['distance_resident_bf16'] == 2
    assert r['routes']['pca_resident_bf16'] == 2


def test_atlas_probe_records_routes():
    recs = probes.probe_atlas(300, dims=(120, 200), n_landmarks=24,
                              epoch_pd=10, epoch_DNN=1, pca_dim=6,
                              device='cpu', out=lambda s: None)
    _check(recs, 'atlas', 'routes', 'nnz', 'phase_timings', 'finite')
    assert recs[0]['ok'] and recs[0]['routes']['weights_spmm'] == 2


def test_residency_probe_forces_each_route():
    recs = probes.probe_residency(
        [(50, 40)], [(50, 80)], pca_dim=6, n_landmarks=12, sketch_rows=(16,),
        foscttm_cells=120, foscttm_blocks=(1000, 100_000), device='cpu',
        out=lambda s: None)
    _check(recs, 'residency', 'kind', 'n', 'f', 'stage', 'arm', 'routes')
    got = {(r['kind'], r['stage'], r['arm']): r['routes'] for r in recs}
    for kind in ('dense', 'csr'):
        assert got[(kind, 'distance', 'resident_bf16')] == {
            'distance_resident_bf16': 1}
        assert got[(kind, 'distance', 'streamed')] == {
            'distance_feature_chunked': 1}
        assert got[(kind, 'pca', 'exact')] == {'pca_direct': 1}
        assert got[(kind, 'pca', 'resident_bf16')] == {'pca_resident_bf16': 1}
        assert got[(kind, 'fps', 'exact')] == {'fps_dense': 1}
        assert got[(kind, 'fps', 'streamed')] == {'fps_jl_sketch': 1}
        assert got[(kind, 'weights', 'exact')] == {'weights_dense': 1}
    assert got[('csr', 'weights', 'resident_bf16')] == {'weights_spmm': 1}
    assert ('csr', 'sketch_block', '16') in got
    assert {r['arm'] for r in recs if r['stage'] == 'foscttm_block'} == {
        '1000', '100000'}


def test_quality_probe_pairs_arms():
    recs = probes.probe_quality(
        seeds=1, small=60, latent_cells=70, latent_dims=(30, 40),
        epoch_DNN=2, epoch_pd=20, band_cells=64, band_seeds=1,
        band_epoch_pd=10, band_epoch_DNN=1, dims=(20, 30), device='cpu',
        out=lambda s: None)
    _check(recs, 'quality')
    summaries = [r for r in recs if 'arms' in r]
    assert [s['comparison'] for s in summaries] == [
        'state/snare', 'rounding/snare', 'state/latent12',
        'rounding/latent12', 'landmark/snare_band']
    for s in summaries:
        for metric in ('foscttm', 'lta'):
            assert np.isfinite(s[metric]['delta'])
    fits = [r for r in recs if 'arm' in r]
    assert len(fits) == 10
    band = [r for r in fits if r['comparison'] == 'landmark/snare_band']
    assert [r['landmark'] for r in band] == [False, True]


def test_route_thresholds_lists_every_global():
    names = probes.route_thresholds()
    assert len(names) == 12
    assert all(isinstance(v, int) and v > 0 for v in names.values())


def test_probes_need_a_card_without_a_device():
    """The command line runs on the card: without one it raises rather
    than measuring the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    with pytest.raises(RuntimeError, match='CUDA'):
        probes.main(['solver', '--sizes', '16'])
