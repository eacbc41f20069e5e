"""The port's benchmark harness (`jamie_tpu_torch.bench`), its generator
(`jamie_tpu_torch.synth`) and residency's transfer accounting, against
the repo's `bench.py`, `examples/synth.py` and `jamie_tpu`'s residency on
the same inputs."""

import contextlib
import importlib
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from jamie_tpu_torch import bench, synth
from jamie_tpu_torch.core import residency as R

ROOT = pathlib.Path(__file__).resolve().parent.parent

# bench.py's record keys: the train leg's (:151-168) and the pipeline
# leg's (:254-300). The MFU key names the card's bf16 peak where bench.py
# names the TPU's (train_mfu_vs_v5e_bf16_peak).
RECORD_KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'extra'}
EXTRA_KEYS = {'train_achieved_tflops', 'train_mfu_vs_card_bf16_peak',
              'scglue_pipeline_seconds', 'scglue_pipeline_vs_ref_cpu',
              'scglue_pipeline_band_seconds',
              'scglue_pipeline_band_vs_ref_cpu', 'scglue_pipeline_reps',
              'input_variant', 'runs'}
RUN_KEYS = {'scglue_pipeline_seconds', 'scglue_pipeline_vs_ref_cpu',
            'epochs_run', 'phases', 'upload_mb', 'upload_mb_bf16_equiv',
            'host_read_s', 'host_encode_s'}
RENAMED = {'train_mfu_vs_card_bf16_peak': 'train_mfu_vs_v5e_bf16_peak'}

TINY_TRAIN = dict(pca_dim=16, epoch_chunk=2, timed_chunks=1)
TINY_FIT = dict(epoch_DNN=3, epoch_pd=20, pca_dim=(16, 16))


def _root_bench():
    spec = importlib.util.spec_from_file_location('root_bench',
                                                  ROOT / 'bench.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _examples_synth():
    path = str(ROOT / 'examples')
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module('synth')


def _tiny_data():
    return synth.make_snare_like(n=80, d_rna=60, d_atac=90)[0]


def test_record_keys_are_bench_py_keys():
    src = (ROOT / 'bench.py').read_text()
    for key in RECORD_KEYS | EXTRA_KEYS | RUN_KEYS:
        assert f"'{RENAMED.get(key, key)}'" in src, key


# ------------------------------------------------------------ generators
@pytest.mark.parametrize('kw', [dict(n=50, d_rna=30, d_atac=40),
                                dict(n=64, d_rna=20, d_atac=70, seed=3)])
def test_make_snare_like_bit_equal(kw):
    (r0, a0), l0 = _root_bench().make_snare_like(**kw)
    (r1, a1), l1 = synth.make_snare_like(**kw)
    assert np.array_equal(r0, r1) and np.array_equal(a0, a1)
    assert np.array_equal(l0, l1)


@pytest.mark.parametrize('binarize1', [None, 0.05, 0.2])
def test_synthesize_bit_equal(tmp_path, monkeypatch, binarize1):
    ex = _examples_synth()
    monkeypatch.setattr(ex, 'SYNTH_CACHE', str(tmp_path / 'jax'))
    monkeypatch.setattr(synth, 'SYNTH_CACHE', str(tmp_path / 'torch'))
    shapes = ((70, 33), (70, 16400))   # two 16,384-column chunks
    want = ex.synthesize(*shapes, seed=1, binarize1=binarize1)
    got = synth.synthesize(*shapes, seed=1, binarize1=binarize1)
    memory = synth.synthesize(*shapes, seed=1, binarize1=binarize1,
                              cache=False)
    cached = synth.synthesize(*shapes, seed=1, binarize1=binarize1)
    assert isinstance(cached[1], np.memmap)
    assert sorted(p.name for p in (tmp_path / 'torch').iterdir()) == \
        sorted(p.name for p in (tmp_path / 'jax').iterdir())
    for w, *gs in zip(want, got, memory, cached):
        for g in gs:
            assert g.dtype == np.float32 and np.array_equal(w, g)


def test_synthesize_sparse_pair_bit_equal(tmp_path, monkeypatch):
    ex = _examples_synth()
    monkeypatch.setattr(ex, 'SYNTH_CACHE', str(tmp_path / 'jax'))
    want = ex.synthesize_sparse_pair(300, 40, 60, density=0.05, seed=2)
    for got in (synth.synthesize_sparse_pair(300, 40, 60, density=0.05,
                                             seed=2, cache=tmp_path / 't'),
                synth.synthesize_sparse_pair(300, 40, 60, density=0.05,
                                             seed=2, cache=tmp_path / 't')):
        for w, g in zip(want, got):
            assert sp.isspmatrix_csr(g) or g.format == 'csr'
            assert (w != g).nnz == 0 and w.nnz == g.nnz
    assert np.array_equal(ex.synthesize_sparse_labels(300, seed=2),
                          synth.synthesize_sparse_labels(300, seed=2))


# ------------------------------------------------------------ bench legs
def _run_main(monkeypatch, env=None, **kw):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    out, err = io.StringIO(), io.StringIO()
    data = synth.synthesize((90, 50), (90, 70), binarize1=0.05, cache=False)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(device='cpu',
                        train_kw=dict(data=_tiny_data(), **TINY_TRAIN),
                        pipeline_kw=dict(data=data, **TINY_FIT), **kw)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines   # the fits' chatter goes to stderr
    return rc, json.loads(lines[0]), err.getvalue()


def test_both_legs_print_one_json_line(monkeypatch):
    rc, rec, err = _run_main(monkeypatch,
                             env={'JAMIE_BENCH_PIPELINE_REPS': '2'})
    assert rc == 0
    assert set(rec) == RECORD_KEYS and set(rec['extra']) == EXTRA_KEYS
    assert rec['metric'] == 'snare_seq_train_cells_per_sec_per_chip'
    assert rec['unit'] == 'cell-samples/s' and rec['value'] > 0
    assert rec['vs_baseline'] == rec['value'] / bench.BASELINE_CELLS_PER_SEC
    extra = rec['extra']
    assert extra['train_achieved_tflops'] > 0
    assert extra['train_mfu_vs_card_bf16_peak'] is None   # no card peak
    assert extra['scglue_pipeline_reps'] == 2 and len(extra['runs']) == 2
    assert extra['input_variant'] == 'zb5'
    secs = sorted(r['scglue_pipeline_seconds'] for r in extra['runs'])
    assert extra['scglue_pipeline_band_seconds'] == secs
    assert extra['scglue_pipeline_seconds'] == pytest.approx(np.mean(secs))
    for run in extra['runs']:
        assert set(run) == RUN_KEYS and run['epochs_run'] == 3
        assert set(run['phases']) == {'Distance', 'Correspondence',
                                      'Mapping'}
    assert '"scglue_foscttm"' in err


def test_one_pipeline_fit_at_a_seed():
    """main(pipeline_kw={'manual_seed': s, 'reps': 1}) runs one pipeline
    fit at that seed, keeps the record's keys, and names the seed and the
    fit's epochs on the stderr progress line (a seed sweep is one such call
    per seed)."""
    seen = []
    once = bench.scglue_pipeline_once

    def spy(data, device=None, **kw):
        seen.append(kw.get('manual_seed'))
        return once(data, device, **kw)
    out, err = io.StringIO(), io.StringIO()
    data = synth.synthesize((90, 50), (90, 70), binarize1=0.05, cache=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, 'scglue_pipeline_once', spy)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(device='cpu',
                            train_kw=dict(data=_tiny_data(), **TINY_TRAIN),
                            pipeline_kw=dict(data=data, manual_seed=5, reps=1,
                                             **TINY_FIT))
    assert rc == 0 and seen == [5]
    rec = json.loads(out.getvalue())
    assert set(rec['extra']) == EXTRA_KEYS
    assert rec['extra']['scglue_pipeline_reps'] == 1
    assert all(set(run) == RUN_KEYS for run in rec['extra']['runs'])
    fits = [json.loads(line) for line in err.getvalue().splitlines()
            if line.startswith('{"scglue_foscttm"')]
    assert [(f['manual_seed'], f['epochs_run']) for f in fits] == [(5, 3)]


def test_pipeline_error_keeps_the_train_record(monkeypatch):
    def boom(**_kw):
        raise RuntimeError('out of memory')
    monkeypatch.setattr(bench, 'scglue_pipeline_noise_controlled', boom)
    rc, rec, _ = _run_main(monkeypatch)
    assert rc != 0
    assert set(rec['extra']) == {'train_achieved_tflops',
                                 'train_mfu_vs_card_bf16_peak',
                                 'scglue_pipeline_error'}
    assert 'out of memory' in rec['extra']['scglue_pipeline_error']
    assert rec['value'] > 0


def test_pipeline_switch_off(monkeypatch):
    rc, rec, _ = _run_main(monkeypatch, env={'JAMIE_BENCH_PIPELINE': '0'})
    assert rc == 0 and set(rec['extra']) == {'train_achieved_tflops',
                                             'train_mfu_vs_card_bf16_peak'}


def test_train_leg_counts_epochs_and_flops():
    """cell-samples = epochs x len_dataloader x batch_size over the timed
    window; the FLOP count covers at least the forward's matmuls."""
    data = _tiny_data()
    rec = bench.train_leg(data=data, device='cpu', **TINY_TRAIN)
    assert rec['value'] > 0 and rec['extra']['train_achieved_tflops'] > 0


# ------------------------------------------------------ transfer accounting
def _jax_residency():
    from jamie_tpu.core import residency as JR
    return JR


def _two_valued(n, f, seed=0):
    rng = np.random.RandomState(seed)
    b = (rng.rand(n, f) < 0.1).astype(np.float32)
    mu, sd = b.mean(0), b.std(0)
    return ((b - mu) / np.where(sd == 0, 1.0, sd)).astype(np.float32)


def _inputs(kind):
    rng = np.random.RandomState(1)
    if kind == 'continuous':
        return rng.randn(300, 70).astype(np.float32)
    if kind == 'two-valued':
        return _two_valued(300, 70)
    x = (rng.rand(300, 70) < 0.05) * rng.rand(300, 70)
    return sp.csr_matrix(x.astype(np.float32))


@pytest.mark.parametrize('kind', ['continuous', 'two-valued', 'csr'])
def test_transfer_stats_of_the_resident_build(monkeypatch, kind):
    """device_bf16 in both packages past a patched-down BF16_LINK_ELEMS:
    the same dense-bf16 equivalent; the port ships 2 bytes an element of a
    dense source, where jamie_tpu's packed bits ship fewer for two-valued
    columns (the deliberate deviation). A resident CSR counts its dense
    equivalent once per build, 2 n f, where jamie_tpu counts it again for
    the decode into the resident copy, 4 n f (the second deviation)."""
    JR = _jax_residency()
    x = _inputs(kind)
    n, f = x.shape
    stats, resident = [], []
    for mod, kw in ((JR, {}), (R, {'device': 'cpu'})):
        monkeypatch.setattr(mod, 'BF16_LINK_ELEMS', 1000)
        mod.clear_residency_cache()
        mod.reset_transfer_stats()
        dev = mod.device_bf16(x, **kw)
        stats.append(mod.transfer_stats())
        resident.append(dev.float().numpy() if mod is R
                        else np.asarray(dev, np.float32))
        mod.clear_residency_cache()
    np.testing.assert_array_equal(resident[1], resident[0])
    jax_s, ours = stats
    if kind == 'csr':   # one DeviceCSR upload, decoded on the device
        assert ours['bf16_equiv_bytes'] == 2 * n * f
        assert jax_s['bf16_equiv_bytes'] == 4 * n * f
        assert ours['bytes'] == 4 * (n + 1) + 8 * x.nnz
        assert ours['read_s'] >= 0 and ours['encode_s'] == 0
    else:
        assert ours['bf16_equiv_bytes'] == jax_s['bf16_equiv_bytes']
        assert ours['bf16_equiv_bytes'] == 2 * n * f
        assert ours['bytes'] == 2 * n * f
        assert ours['encode_s'] > 0
    if kind == 'two-valued':
        assert jax_s['bytes'] < ours['bytes']
    if kind == 'continuous':
        assert jax_s['bytes'] == ours['bytes']


@pytest.mark.parametrize('exact', [True, False])
def test_transfer_stats_of_the_chunk_uploader(monkeypatch, exact):
    """ChunkUploader rows/cols: exact f32 (4 bytes an element) under
    BF16_LINK_ELEMS, bf16 (2) at or above it; jamie_tpu's dense-bf16
    equivalent either way."""
    JR = _jax_residency()
    x = np.random.RandomState(2).randn(200, 50).astype(np.float32)
    limit = 10 ** 9 if exact else 1000
    stats = []
    for mod, kw in ((JR, {}), (R, {'device': 'cpu'})):
        monkeypatch.setattr(mod, 'BF16_LINK_ELEMS', limit)
        mod.reset_transfer_stats()
        up = mod.ChunkUploader(x, **kw)
        up.rows(0, 120)
        up.cols(10, 30)
        stats.append(mod.transfer_stats())
    jax_s, ours = stats
    elems = 120 * 50 + 200 * 20
    assert ours['bf16_equiv_bytes'] == jax_s['bf16_equiv_bytes'] == 2 * elems
    assert ours['bytes'] == (4 if exact else 2) * elems == jax_s['bytes']


def test_chunk_uploader_counts_a_resident_csr_once(monkeypatch):
    """Rows decoded from a resident CSR ship nothing: one DeviceCSR build
    counts 2 n f however many passes read it, where jamie_tpu counts each
    pass again (the deviation of test_transfer_stats_of_the_resident_build)."""
    JR = _jax_residency()
    x = _inputs('csr')
    n, f = x.shape
    stats = []
    for mod, kw in ((JR, {}), (R, {'device': 'cpu'})):
        mod.clear_residency_cache()
        mod.reset_transfer_stats()
        up = mod.ChunkUploader(x, **kw)
        assert up.dcsr is not None
        for _ in range(2):
            up.rows(0, n)
        stats.append(mod.transfer_stats())
        mod.clear_residency_cache()
    jax_s, ours = stats
    assert ours['bf16_equiv_bytes'] == 2 * n * f
    assert jax_s['bf16_equiv_bytes'] == 3 * 2 * n * f
    assert ours['bytes'] == 4 * (n + 1) + 8 * x.nnz


def test_csr_to_device_counts_its_csr_payload():
    x = _inputs('csr')
    R.reset_transfer_stats()
    dense = R.csr_to_device(x, 'cpu')
    st = R.transfer_stats()
    np.testing.assert_array_equal(dense.numpy(), x.toarray())
    assert st['bytes'] == 4 * (x.shape[0] + 1) + 8 * x.nnz
    assert st['bf16_equiv_bytes'] == 2 * x.shape[0] * x.shape[1]
    R.reset_transfer_stats()
    assert R.transfer_stats() == {'bytes': 0, 'bf16_equiv_bytes': 0,
                                  'read_s': 0.0, 'encode_s': 0.0,
                                  'copy_s': 0.0}
