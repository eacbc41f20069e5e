"""Mid-fit snapshots, exact resume, the per-chunk metrics log and the
occlusion / SHAP explanations of jamie_tpu_torch: every case of
tests/test_checkpoint_resume.py on the port, the resume held bit for bit
to the uninterrupted fit, the metrics log to jamie_tpu's for the same
config, and occlusion and SHAP to jamie_tpu's on one model that jamie_tpu
fitted and the port loaded."""

import json
import os

import numpy as np
import pytest
import torch

from jamie_tpu import JAMIE as JaxJAMIE
from jamie_tpu.config import JamieConfig as JConfig
from jamie_tpu.models import CoupledVAE as FlaxVAE
from jamie_tpu.train.trainer import JamieTrainer as JTrainer
from jamie_tpu_torch import JAMIE
from jamie_tpu_torch.config import JamieConfig
from jamie_tpu_torch.evaluation import (occlusion_impact_device,
                                        shap_explain)
from jamie_tpu_torch.models import CoupledVAE
from jamie_tpu_torch.train.trainer import FitState, JamieTrainer


def _inputs():
    rng = np.random.RandomState(0)
    n = 48
    z = rng.randn(n, 4).astype(np.float32)
    x0 = (z @ rng.randn(4, 12)).astype(np.float32)
    x1 = (z @ rng.randn(4, 9)).astype(np.float32)
    return n, x0, x1


def _cfg_kw(**overrides):
    return {**dict(epoch_DNN=20, min_epochs=5, batch_size=24, epoch_chunk=5,
                   log_DNN=1000, use_early_stop=False, pca_dim=None),
            **overrides}


def _trainer(compute_dtype=torch.float32, dropout=0.0, **overrides):
    n, x0, x1 = _inputs()
    cfg = JamieConfig(**_cfg_kw(**overrides))
    model = CoupledVAE((12, 9), cfg.output_dim, dropout=dropout,
                       compute_dtype=compute_dtype)
    return JamieTrainer(cfg, model, [x0, x1], np.eye(n, dtype=np.float32),
                        np.zeros((n, n), np.float32), device='cpu')


def _jax_trainer(**overrides):
    n, x0, x1 = _inputs()
    cfg = JConfig(**_cfg_kw(**overrides))
    return JTrainer(cfg, FlaxVAE((12, 9), cfg.output_dim, dropout=0.0),
                    [x0, x1], np.eye(n, dtype=np.float32),
                    np.zeros((n, n), np.float32))


def test_fit_state_roundtrip(tmp_path):
    trainer = _trainer()
    state = trainer.fit()
    path = str(tmp_path / 'ckpt')
    trainer.save_fit_state(path, state)
    restored = trainer.restore_fit_state(path)
    emb1 = trainer.final_embed(state)
    emb2 = trainer.final_embed(restored)
    np.testing.assert_array_equal(emb1[0], emb2[0])
    assert restored.epoch == state.epoch == 20


def test_resume_continues_training(tmp_path):
    trainer = _trainer(epoch_DNN=10)
    state = trainer.fit()
    assert state.epoch == 10
    trainer2 = _trainer(epoch_DNN=20)
    path = str(tmp_path / 'ckpt2')
    trainer.save_fit_state(path, state)
    restored = trainer2.restore_fit_state(path)
    final = trainer2.fit(state=restored)
    assert final.epoch == 20
    assert trainer2.epochs_run == 10  # only the new epochs ran


def _assert_states_equal(a: FitState, b: FitState):
    for name in ('params', 'mu', 'nu', 'rng'):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), \
            name
    assert a.batch_stats.keys() == b.batch_stats.keys()
    for k in a.batch_stats:
        assert torch.equal(a.batch_stats[k], b.batch_stats[k]), k
    for name in ('count', 'epoch', 'best_running_loss', 'streak', 'stopped'):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('batch_step', [True, False])
def test_resume_equals_uninterrupted_fit(tmp_path, compute_dtype, batch_step):
    """10 epochs, a snapshot, and fit(state=restore_fit_state(...)) to 20
    on a fresh trainer equal the uninterrupted 20-epoch fit bit for bit:
    embeddings, parameters, Adam moments and count, generator, epoch, best
    loss and streak (dropout on, so the generator carries the draws;
    early-stop bookkeeping live past min_epochs: with min_increment 1e9
    only the first epoch past it improves, and the streak counts on)."""
    kw = dict(compute_dtype=compute_dtype, dropout=0.3, batch_step=batch_step,
              min_increment=1e9)
    whole = _trainer(**kw)
    full = whole.fit()
    first = _trainer(epoch_DNN=10, **kw)
    first.fit(checkpoint_dir=str(tmp_path), checkpoint_every=10)
    assert sorted(os.listdir(tmp_path)) == ['epoch_10']
    resumed = _trainer(**kw)
    final = resumed.fit(state=resumed.restore_fit_state(
        str(tmp_path / 'epoch_10')))
    _assert_states_equal(final, full)
    assert final.streak == 20 - 7 and np.isfinite(final.best_running_loss)
    for a, b in zip(resumed.final_embed(), whole.final_embed()):
        np.testing.assert_array_equal(a, b)
    assert resumed.epoch_losses == whole.epoch_losses[10:]


def test_metrics_jsonl(tmp_path):
    trainer = _trainer(epoch_DNN=10)
    path = str(tmp_path / 'metrics.jsonl')
    trainer.fit(metrics_path=path)
    records = [json.loads(line) for line in open(path)]
    assert len(records) == 2  # 10 epochs / chunk 5
    assert records[0]['epoch_start'] == 0
    assert records[0]['epoch_end'] == 5
    assert set(records[0]['losses']) == {'KL', 'Rec', 'CosSim', 'F'}
    assert records[0]['seconds'] > 0
    assert records[0]['memory'] == {}           # no device stats on the CPU


@pytest.mark.parametrize('overrides', [
    dict(epoch_DNN=13, epoch_chunk=5),
    # streak 2 past min_epochs 5: the stop lands inside the second chunk
    dict(epoch_DNN=20, epoch_chunk=5, use_early_stop=True,
         max_steps_without_increment=2, min_increment=1e9),
])
def test_metrics_jsonl_matches_reference(tmp_path, overrides):
    """The same config in both packages writes the same number of records
    with the same epoch ranges (an early stop ends the last range at the
    epochs that ran) and the same keys."""
    out = []
    for name, trainer in (('jax', _jax_trainer(**overrides)),
                          ('torch', _trainer(**overrides))):
        path = str(tmp_path / f'{name}.jsonl')
        trainer.fit(metrics_path=path)
        out.append([json.loads(line) for line in open(path)])
    ref, ours = out
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert set(o) == set(r)
        assert (o['epoch_start'], o['epoch_end']) == (r['epoch_start'],
                                                      r['epoch_end'])
        assert set(o['losses']) == set(r['losses'])


def test_checkpoint_and_metrics_via_config(tmp_path):
    rng = np.random.RandomState(7)
    z = rng.randn(40, 4).astype(np.float32)
    data = [(z @ rng.randn(4, 10)).astype(np.float32),
            (z @ rng.randn(4, 8)).astype(np.float32)]
    mpath = str(tmp_path / 'metrics.jsonl')
    jm = JAMIE(device='cpu', epoch_DNN=10, min_epochs=2, batch_size=20,
               epoch_chunk=5, pca_dim=None, use_f_tilde=False,
               use_early_stop=False, dropout=0.0, log_DNN=1000,
               checkpoint_dir=str(tmp_path / 'ckpts'), checkpoint_every=5,
               metrics_path=mpath)
    jm.fit_transform(dataset=data)
    records = [json.loads(line) for line in open(mpath)]
    assert len(records) == 2
    ckpts = sorted((tmp_path / 'ckpts').iterdir())
    assert [c.name for c in ckpts] == ['epoch_10', 'epoch_5']
    restored = jm.trainer.restore_fit_state(str(ckpts[0]))
    assert restored.epoch in (5, 10)
    assert jm.train_state.epoch == 10


def test_fit_does_not_invalidate_caller_state(tmp_path):
    trainer = _trainer(epoch_DNN=10)
    state = trainer.fit()
    path = str(tmp_path / 'ckpt3')
    trainer.save_fit_state(path, state)
    kept = trainer.restore_fit_state(path)
    before = kept.params.clone()
    trainer2 = _trainer(epoch_DNN=15)
    trainer2.fit(state=kept)
    emb = trainer2.final_embed(kept)
    assert np.isfinite(emb[0]).all()
    assert kept.epoch == 10 and torch.equal(kept.params, before)
    # final_embed(state) puts the trainer's own parameters back
    np.testing.assert_array_equal(trainer2.final_embed()[0],
                                  trainer2.final_embed()[0])
    assert not np.array_equal(trainer2.final_embed()[0], emb[0])


def test_checkpoint_relative_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = _trainer()
    state = trainer.fit()
    trainer.save_fit_state('ckpts/epoch_20', state)
    restored = trainer.restore_fit_state('ckpts/epoch_20')
    assert restored.epoch == state.epoch


def test_restore_rejects_another_model(tmp_path):
    trainer = _trainer(epoch_DNN=2)
    trainer.save_fit_state(str(tmp_path / 's'), trainer.fit())
    other = JamieTrainer(JamieConfig(**_cfg_kw()), CoupledVAE((12, 8), 32),
                         [np.zeros((48, 12), np.float32),
                          np.zeros((48, 8), np.float32)],
                         np.eye(48, dtype=np.float32),
                         np.zeros((48, 48), np.float32), device='cpu')
    state = other.restore_fit_state(str(tmp_path / 's'))
    with pytest.raises(ValueError):
        other.fit(state=state)
    with pytest.raises(ValueError):
        other.final_embed(state)


def _trainer_with_P(P):
    n, x0, x1 = _inputs()
    cfg = JamieConfig(**_cfg_kw(epoch_DNN=10))
    model = CoupledVAE((12, 9), cfg.output_dim, dropout=0.0)
    return JamieTrainer(cfg, model, [x0, x1], P, np.zeros((n, n), np.float32),
                        device='cpu')


def test_diag_mask_with_nonunit_weights_is_hybrid():
    assert _trainer_with_P(np.full(48, 0.5, np.float32)).sampling_method \
        == 'hybrid'
    assert _trainer_with_P(np.ones(48, np.float32)).sampling_method == 'diag'


@pytest.mark.parametrize('flags', [dict(model_matmul_dtype='bfloat16'),
                                   dict(compute_dtype='bfloat16')])
def test_save_load_preserves_numerics_flags(tmp_path, synthetic_pair, flags):
    """A model fitted with bf16 matmuls or bf16 compute serves the same way
    after save_model / load_model."""
    data, _ = synthetic_pair
    jm = JAMIE(device='cpu', epoch_DNN=40, min_epochs=10, batch_size=64,
               pca_dim=None, use_f_tilde=False, use_early_stop=False,
               dropout=0.0, log_DNN=10000, **flags)
    jm.fit_transform(dataset=data)
    path = str(tmp_path / 'm.npz')
    jm.save_model(path)
    jm2 = JAMIE(device='cpu').load_model(path)
    assert jm2.model.matmul_bf16 == jm.model.matmul_bf16
    assert jm2.model.compute_dtype == jm.model.compute_dtype
    np.testing.assert_array_equal(jm.modal_predict(data[0], 0),
                                  jm2.modal_predict(data[0], 0))


# ------------------------------------------------------------ explanations
def test_occlusion_impact_device(synthetic_pair):
    data, _ = synthetic_pair
    jm = JAMIE(device='cpu', epoch_DNN=150, min_epochs=50, batch_size=64,
               pca_dim=None, use_f_tilde=False, use_early_stop=False,
               dropout=0.0, log_DNN=10000)
    jm.fit_transform(dataset=data)
    baseline, impact, idx = occlusion_impact_device(
        jm, data[0], data[1], modality=0, batch_features=16)
    assert np.isfinite(baseline)
    assert impact.shape == (data[0].shape[1],)
    assert np.isfinite(impact).all()
    # batch_features changes only how the copies are grouped
    _, impact7, _ = occlusion_impact_device(jm, data[0], data[1],
                                            batch_features=7)
    np.testing.assert_allclose(impact7, impact, rtol=0, atol=1e-6)


@pytest.fixture(scope='module')
def jax_fitted(synthetic_pair, tmp_path_factory):
    """One model fitted by jamie_tpu (PCA preclass), and the port's JAMIE
    that loaded its checkpoint."""
    data, _ = synthetic_pair
    jj = JaxJAMIE(use_mesh=False, epoch_DNN=100, min_epochs=30,
                  epoch_chunk=50, batch_size=64, pca_dim=(16, 12),
                  use_f_tilde=False, use_early_stop=False, dropout=0.0,
                  log_DNN=10000)
    jj.fit_transform(dataset=data)
    path = str(tmp_path_factory.mktemp('jax_fitted') / 'model.npz')
    jj.save_model(path)
    return jj, JAMIE(device='cpu').load_model(path), data


def test_occlusion_input_space_matches_bruteforce(jax_fitted):
    """space='input' (PCA preclass): the linear-shortcut occlusion equals
    re-transforming the occluded raw matrix, within 2e-5."""
    _, tj, data = jax_fitted
    test_feats = np.array([0, 7, 33])
    baseline, impact, idx = occlusion_impact_device(
        tj, data[0], data[1], modality=0, batch_features=4, idx=test_feats)
    assert (idx == test_feats).all()
    pre_in, pre_out = tj.preprocessors
    raw = np.asarray(data[0], np.float32)
    true_t = torch.as_tensor(pre_out.transform(np.asarray(data[1],
                                                          np.float32)))

    def mean_r(pred):
        pc = pred - pred.mean(0)
        tc = true_t - true_t.mean(0)
        num = (pc * tc).sum(0)
        den = torch.linalg.vector_norm(pc, dim=0) * \
            torch.linalg.vector_norm(tc, dim=0)
        return float((num / torch.clamp(den, min=1e-12)).mean())

    for j, fid in enumerate(test_feats):
        occ = raw.copy()
        occ[:, fid] = occ[:, fid].mean()
        with torch.no_grad():
            pred = tj.model.impute(torch.as_tensor(pre_in.transform(occ)),
                                   0, 1)
        np.testing.assert_allclose(impact[j], baseline - mean_r(pred),
                                   atol=2e-5)
    _, lat_impact, lat_idx = occlusion_impact_device(
        tj, data[0], data[1], modality=0, batch_features=8, space='latent')
    assert lat_impact.shape == (16,) and np.isfinite(lat_impact).all()


@pytest.mark.parametrize('space', ['input', 'latent'])
@pytest.mark.parametrize('modality', [0, 1])
def test_occlusion_matches_reference(jax_fitted, space, modality):
    """The port's batched forward against jamie_tpu's vmap on the same
    model: baseline and impacts within 1e-5."""
    from jamie_tpu.evaluation import occlusion_impact_device as jax_occ
    jj, tj, data = jax_fitted
    to = 1 - modality
    ref = jax_occ(jj, data[modality], data[to], modality=modality,
                  batch_features=8, space=space)
    ours = occlusion_impact_device(tj, data[modality], data[to],
                                   modality=modality, batch_features=8,
                                   space=space)
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours[2], ref[2])


def test_shap_explain_matches_reference(jax_fitted):
    """shap_explain without the shap package (native kernel_shap, the same
    coalitions from the same seed) on the same model: phi within rtol
    1e-4 (plus 1e-4 of its largest entry for entries near zero), the base
    values within 1e-5, efficiency to modal_predict within 1e-4."""
    from jamie_tpu.evaluation import shap_explain as jax_shap
    jj, tj, data = jax_fitted
    x = data[0][:6]
    ref = jax_shap(jj, x, modality=0, max_evals=96, features=np.arange(10))
    ours = shap_explain(tj, x, modality=0, max_evals=96,
                        features=np.arange(10))
    assert ours.values.shape == (6, 10, data[1].shape[1])
    scale = np.abs(ref.values).max()
    np.testing.assert_allclose(ours.values, ref.values, rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(ours.base_values, ref.base_values, rtol=0,
                               atol=1e-5)
    total = tj.modal_predict(x, 0) - ours.base_values
    np.testing.assert_allclose(ours.values.sum(axis=1), total, rtol=0,
                               atol=1e-4 * np.abs(total).max())
    assert len(ours) == 6 and ours[2].values.shape == ours.values[2].shape


def test_device_memory_stats_and_trace(tmp_path):
    """core/timing: no device statistics on the CPU (jamie_tpu's CPU
    backend reports none either), and trace() writes a Chrome trace of the
    enclosed work."""
    from jamie_tpu.core.timing import device_memory_stats as jax_stats
    from jamie_tpu_torch.core.timing import device_memory_stats, trace
    assert device_memory_stats('cpu') == jax_stats() == {}
    with trace(str(tmp_path / 'trace')):
        _trainer(epoch_DNN=1).fit()
    events = json.load(open(tmp_path / 'trace' / 'trace.json'))
    assert events['traceEvents']
