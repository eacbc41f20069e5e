"""The synthetic-data examples of `jamie_tpu_torch.examples` against the
repo's `examples/`: bit-equal generators and split, the kNN baseline of
the imputation flow against jamie_tpu's (to 1e-5 of the output's scale),
the atlas trainer's sampling regime against jamie_tpu's for both priors,
and each twin's `main` at a tiny size on the CPU (at most 80 cells, 20
epochs), with the example's record keys and finite outputs."""

import faulthandler
import importlib
import pathlib
import signal
import sys

import numpy as np
import pytest

from jamie_tpu_torch.examples import (atlas_scale, imputation_comparison,
                                      sample, tuning)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _example(name):
    """examples/<name>.py, imported by path; the SIGTERM stack dump that
    examples/atlas_scale.py installs at import is taken out again."""
    path = str(ROOT / 'examples')
    if path not in sys.path:
        sys.path.insert(0, path)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        return importlib.import_module(name)
    finally:
        if name == 'atlas_scale':
            faulthandler.unregister(signal.SIGTERM)
            signal.signal(signal.SIGTERM, prev)


def _source(name):
    return (ROOT / 'examples' / f'{name}.py').read_text()


@pytest.mark.parametrize('kw', [{}, dict(n=57, seed=3)])
def test_make_branching_pair_bit_equal(kw):
    (x1, x2), labels = sample.make_branching_pair(**kw)
    (r1, r2), ref_labels = _example('sample').make_branching_pair(**kw)
    for a, b in ((x1, r1), (x2, r2)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(labels, ref_labels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('kw', [dict(n=500, d_rna=16, d_atac=24),
                                dict(n=300, d_rna=40, d_atac=8, seed=2)])
def test_make_multiome_bit_equal(kw):
    ours = atlas_scale.make_multiome(**kw)
    ref = _example('atlas_scale').make_multiome(**kw)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('n', [400, 80])
def test_imputation_split_equal(n):
    """The example's split, as its lines compute it."""
    lines = ('np.random.seed(42)',
             'train_idx = np.random.choice(n, int(0.8 * n), replace=False)',
             'test_idx = np.array(sorted(set(range(n)) - set(train_idx)))')
    src = _source('imputation_comparison')
    assert all(line in src for line in lines)
    np.random.seed(42)
    train_ref = np.random.choice(n, int(0.8 * n), replace=False)
    test_ref = np.array(sorted(set(range(n)) - set(train_ref)))
    train_idx, test_idx = imputation_comparison.split(n)
    np.testing.assert_array_equal(train_idx, train_ref)
    np.testing.assert_array_equal(test_idx, test_ref)
    assert len(train_idx) == int(0.8 * n)
    assert len(test_idx) == n - len(train_idx)


def test_predict_knn_of_the_flow_matches_jamie_tpu():
    from jamie_tpu.utils import predict_knn as jax_predict_knn
    from jamie_tpu_torch.utils import predict_knn
    dataset, _ = sample.make_branching_pair(n=80)
    train_idx, _ = imputation_comparison.split(80)
    train = [d[train_idx] for d in dataset]
    for src, dst, val in ((train[1], train[0], dataset[1]),
                          (train[0], train[1], dataset[0])):
        got = predict_knn(src, dst, val=val, device='cpu')
        ref = jax_predict_knn(src, dst, val=val)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize('prior', [None, 0.5])
def test_atlas_sampling_matches_jamie_tpu(prior):
    """The trainer the default mode builds samples as jamie_tpu's does:
    'diag' on the identity sentinel, 'hybrid' on the SparseRows diagonal
    (the same RandomState(1) draw)."""
    from jamie_tpu.config import JamieConfig as JConfig
    from jamie_tpu.models import CoupledVAE as JVAE
    from jamie_tpu.ops.sparse import SparseRows as JSparseRows
    from jamie_tpu.train.trainer import JamieTrainer as JTrainer
    from jamie_tpu_torch.config import JamieConfig
    from jamie_tpu_torch.models import CoupledVAE
    from jamie_tpu_torch.ops.sparse import SparseRows
    from jamie_tpu_torch.train.trainer import JamieTrainer
    n = 256
    data = atlas_scale.make_multiome(n, 16, 16)
    methods = []
    for Config, VAE, Rows, Trainer, kw in (
            (JConfig, JVAE, JSparseRows, JTrainer, {}),
            (JamieConfig, CoupledVAE, SparseRows, JamieTrainer,
             {'device': 'cpu'})):
        if prior is None:
            P = 'identity'
        else:
            on = np.random.RandomState(1).choice(n, int(prior * n),
                                                 replace=False)
            P = Rows.from_coo(on, on, np.ones(len(on), np.float32), (n, n))
        cfg = Config(epoch_DNN=2, min_epochs=1, batch_size=64,
                     use_early_stop=False, pca_dim=None, log_DNN=10 ** 9,
                     epoch_chunk=20)
        model = VAE((16, 16), cfg.output_dim, dropout=0.6)
        methods.append(Trainer(cfg, model, data, P, 'zeros',
                               **kw).sampling_method)
    assert methods[0] == methods[1] == ('diag' if prior is None
                                        else 'hybrid')


# The record keys: the atlas modes' as the example's JSON holds them; the
# walkthrough's and the search's are what the example prints
ATLAS_KEYS = ('cells', 'devices', 'sampling', 'epochs', 'fit_seconds',
              'cell_samples_per_sec', 'embedding_shapes', 'finite', 'hbm')
SPARSE_KEYS = ('cells', 'features', 'nnz_frac', 'devices', 'fit_seconds',
               'phase_seconds', 'mapping_seconds', 'foscttm_exact',
               'label_transfer_acc', 'label_transfer_k',
               'label_transfer_cells', 'metric_seconds', 'hbm',
               'peak_rss_gb', 'transfer')
IMPUTATION_KEYS = ('jamie_r', 'knn_r', 'nn_r')
SAMPLE_PRINTS = {'foscttm': 'jm.test_closer(integrated)',
                 'label_transfer_accuracy': "'label transfer accuracy:'",
                 'mean_imputation_r': "'mean imputation r:'",
                 'model_path': "jm.save_model(",
                 'figure': "'figure saved to",
                 }
TUNING_PRINTS = {'best_weights': "'best weights:'"}


def test_record_keys_are_the_examples():
    src = _source('atlas_scale')
    for key in ATLAS_KEYS + SPARSE_KEYS:
        assert f"'{key}':" in src, key
    src = _source('imputation_comparison')
    for key in IMPUTATION_KEYS:
        assert f"'{key}':" in src, key
    assert "results['figure']" in src
    for name, prints in (('sample', SAMPLE_PRINTS),
                         ('tuning', TUNING_PRINTS)):
        for key, text in prints.items():
            assert text in _source(name), (name, key)


def _finite(values):
    return all(np.isfinite(np.asarray(v, np.float64)).all() for v in values)


def test_sample_main_tiny(tmp_path):
    seen = {}
    rec = sample.main(out_dir=str(tmp_path), device='cpu', n=80,
                      epoch_DNN=20, min_epochs=10, epoch_pd=20,
                      on_fit=lambda jm, emb, data: seen.update(
                          shapes=[e.shape for e in emb], jm=jm))
    assert set(rec) == set(SAMPLE_PRINTS)
    assert _finite([rec['foscttm'], rec['label_transfer_accuracy'],
                    rec['mean_imputation_r']])
    assert seen['shapes'] == [(80, 32), (80, 32)]
    assert rec['figure'] and pathlib.Path(rec['figure']).is_file()
    # the checkpoint serves the same imputation
    from jamie_tpu_torch import JAMIE
    x = sample.make_branching_pair(80)[0][0]
    np.testing.assert_array_equal(
        JAMIE(device='cpu').load_model(rec['model_path']).modal_predict(x, 0),
        seen['jm'].modal_predict(x, 0))


def test_tuning_main_tiny():
    rec = tuning.main(num_search=2, device='cpu', n=60, epoch_DNN=5,
                      min_epochs=2, epoch_pd=20)
    assert set(rec) >= set(TUNING_PRINTS)
    assert len(rec['best_weights']) == 4 and _finite(rec['best_weights'])
    assert rec['best_embedding_shapes'] == [[60, 32], [60, 32]]
    assert rec['best_finite']


def test_imputation_comparison_main_tiny(tmp_path):
    rec = imputation_comparison.main(out_dir=str(tmp_path), device='cpu',
                                     n=80, epoch_DNN=20, min_epochs=10,
                                     epoch_pd=20, nn_epochs=2)
    assert set(rec) == set(IMPUTATION_KEYS) | {'figure'}
    for key in IMPUTATION_KEYS:
        assert len(rec[key]) == 2 and _finite(rec[key])
    assert pathlib.Path(rec['figure']).is_file()


@pytest.mark.filterwarnings('ignore:.*found in sys.modules:RuntimeWarning')
def test_imputation_comparison_scgem_arm_on_fixture_files(monkeypatch,
                                                          tmp_path, capsys):
    """`--scgem` on scGEM-format files in --data-dir, from the command
    line: one seed, the example's record keys, finite r per method."""
    import json
    import runpy
    from test_torch_examples_data import write_scgem
    write_scgem(tmp_path, n=60)
    monkeypatch.setattr(sys, 'argv', [
        'imputation_comparison', '--scgem', '--seeds', '1', '--data-dir',
        str(tmp_path), '--device', 'cpu', '--epoch-dnn', '20',
        '--min-epochs', '10', '--epoch-pd', '30'])
    runpy.run_module('jamie_tpu_torch.examples.imputation_comparison',
                     run_name='__main__')
    out = capsys.readouterr().out
    rec = json.loads(out[out.rindex('\n{'):])
    assert rec['n_seeds'] == 1 and rec['dataset'] == 'scGEM (real, 80/20)'
    for method in ('jamie', 'knn', 'nn'):
        for i in (1, 2):
            assert np.isfinite(rec[f'{method}_r_mod{i}_mean'])
            assert len(rec[f'{method}_r_mod{i}_runs']) == 1
    assert set(rec) >= {'jamie_gt_knn_mod1_runs', 'jamie_gt_nn_mod2_runs'}


@pytest.mark.parametrize('argv', [
    [], ['--sparse-prior', '0.5'],
    ['--sparse-data', '--features', '60', '90', '--landmarks', '32',
     '--epoch-pd', '20', '--metric-cells', '40'],
], ids=['identity', 'sparse-prior', 'sparse-data'])
def test_atlas_scale_main_tiny(argv):
    rec = atlas_scale.main(['--cells', '80', '--epochs', '2',
                            '--batch-size', '32', '--device', 'cpu', *argv],
                           cache=False)
    if '--sparse-data' in argv:
        assert set(rec) == set(SPARSE_KEYS) | {'generate_seconds'}
        assert 0 <= rec['foscttm_exact'] <= 1
        assert rec['label_transfer_cells'] == 40
        assert rec['features'] == [60, 90]
        assert set(rec['transfer']) == {'bytes', 'bf16_equiv_bytes',
                                        'read_s', 'encode_s', 'copy_s'}
        assert rec['hbm'] == {} and rec['devices'] == 1
    else:
        assert set(rec) == set(ATLAS_KEYS)
        assert rec['sampling'] == ('hybrid' if argv else 'diag')
        assert rec['embedding_shapes'] == [[80, 32], [80, 32]]
        assert rec['finite'] and rec['epochs'] == 2
        assert rec['cell_samples_per_sec'] > 0
