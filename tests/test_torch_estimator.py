"""JAMIE().fit_transform in both packages on the CPU, and checkpoints that
cross between them."""

import os

import numpy as np
import pytest
import scipy.sparse

from jamie_tpu import JAMIE as JaxJAMIE
from jamie_tpu_torch import JAMIE

# tests/test_end_to_end.py's FAST kwargs, with the default distance mode
# and PCA on (the port's main path)
FAST = dict(epoch_DNN=400, min_epochs=100, epoch_chunk=100, log_DNN=10_000,
            batch_size=64, pca_dim=(20, 10), distance_mode='geodesic',
            epoch_pd=300, use_early_stop=False, dropout=0.0)


@pytest.fixture(scope='module')
def fitted(synthetic_pair):
    data, labels = synthetic_pair
    jj = JaxJAMIE(use_mesh=False, **FAST)
    jax_out = jj.fit_transform(dataset=data)
    tj = JAMIE(device='cpu', **FAST)
    torch_out = tj.fit_transform(dataset=data)
    return jj, jax_out, tj, torch_out, data, labels


def test_correspondence_matches(fitted):
    """F is deterministic given the distances. Both solvers run bf16
    operands with f32 results (solver_dtype='bfloat16'), whose f32
    summation orders differ; over 300 iterations the drift is 1.3e-5 of
    F's max on this input, held at 1e-4, and the matched cell (row argmax)
    is the same."""
    jj, _, tj, _, _, _ = fitted
    ref = np.asarray(jj.match_result[0])
    ours = tj.match_result[0].cpu().numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * ref.max())
    assert np.mean(ours.argmax(1) == ref.argmax(1)) > 0.95


def test_integration_quality_in_the_same_band(fitted):
    jj, jax_out, tj, torch_out, _, labels = fitted
    f_ref, f_ours = jj.test_closer(jax_out), tj.test_closer(torch_out)
    lta_ref = jj.test_LabelTA(jax_out, labels)
    lta_ours = tj.test_LabelTA(torch_out, labels)
    assert f_ours < 0.15 and lta_ours > 0.8, (f_ours, lta_ours)
    # measured: FOSCTTM 0.0277 vs 0.0280, LTA 1.0 in both (different
    # sampling and noise streams, so a band rather than equality)
    assert abs(f_ours - f_ref) < 0.02 and abs(lta_ours - lta_ref) < 0.05
    assert torch_out[0].shape == jax_out[0].shape == (120, 32)
    keys, dist = tj.test_label_dist(torch_out, labels, verbose=False)
    assert list(keys) == ['a', 'b'] and dist.shape == (2, 2)
    assert dist[0, 0] == 0 and dist[0, 1] > 0


def test_serving_calls(fitted):
    _, _, tj, torch_out, data, _ = fitted
    re = tj.transform(data)
    np.testing.assert_allclose(re[0], torch_out[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tj.transform_one(data[1], 1), torch_out[1],
                               rtol=1e-5, atol=1e-5)
    assert tj.modal_predict(data[0], 0).shape == data[1].shape


@pytest.mark.parametrize('direction', ['jax_to_torch', 'torch_to_jax'])
def test_checkpoints_cross_load(fitted, tmp_path, direction):
    jj, _, tj, _, data, _ = fitted
    path = os.path.join(tmp_path, 'model.npz')
    src, dst = ((jj, JAMIE(device='cpu')) if direction == 'jax_to_torch'
                else (tj, JaxJAMIE(use_mesh=False)))
    src.save_model(path)
    dst.load_model(path)
    for m in (0, 1):
        np.testing.assert_allclose(dst.modal_predict(data[m], m),
                                   src.modal_predict(data[m], m),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dst.transform_one(data[m], m),
                                   src.transform_one(data[m], m),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('kwargs, item', [
    ({'project_mode': 'tsne'}, 12), ({'model_pca': 'umap'}, 12),
    ({'corr_method': 'jamie'}, 12), ({'compute_dtype': 'bfloat16'}, 13),
    ({'corr_landmarks': 64}, 10), ({'f_top_k': 8}, 9),
    ({'checkpoint_dir': 'ckpt'}, 13), ({'metrics_path': 'm.jsonl'}, 13),
    ({'mesh': object()}, 14),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=f'ROADMAP.md item {item}'):
        JAMIE(device='cpu', **kwargs)


def test_unported_inputs_raise(synthetic_pair):
    data, _ = synthetic_pair
    with pytest.raises(NotImplementedError, match='item 11'):
        JAMIE(device='cpu').fit_transform(
            [scipy.sparse.csr_matrix(d) for d in data])
    with pytest.raises(NotImplementedError, match='item 12'):
        JAMIE(device='cpu', distance_mode='cosine', epoch_pd=1).fit_transform(
            data)
