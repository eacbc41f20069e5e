"""A run with its timed path broken underneath comes out not correct:
one run for each fault a one-chip fit can have (a step that returns its
state unchanged, half of each batch left out, an answer altered where it
is produced). The exchange between chips does not exist in these cells
(one chip each)."""

import pytest

import control
import run
from control import _patched

LIMITS = {'dist': 1e-3, 'f': 1e-2, 'pca': 1e-3, 'embed': 1e-4,
          'loss': 1e-4, 'dtheta': 1e-2, 'nu': 1e-2, 'foscttm': 0.3}


def embedding_altered():
    """The final embedding's second half of rows replaced by the mean of
    the first half, where the trainer produces it."""
    from jamie_tpu_torch.train import trainer

    def make(old):
        def final_embed(self, state=None):
            out = old(self, state)
            for e in out:
                h = len(e) // 2
                e[h:] = e[:h].mean(0)
            return out
        return final_embed
    return _patched(trainer.JamieTrainer, 'final_embed', make)


def answer_altered():
    """One row of F (one cell's correspondence) altered where the solver
    produces it."""
    from jamie_tpu_torch import estimator

    def make(old):
        def prime_dual(*a, **k):
            F = old(*a, **k)
            F[0] += F.abs().max()
            return F
        return prime_dual
    return _patched(estimator, 'prime_dual', make)


def distances_altered():
    """One modality's distance matrix scaled by 1% where it is made."""
    from jamie_tpu_torch import estimator

    def make(old):
        def dataset_distance_matrix(data, *a, **k):
            d = old(data, *a, **k)
            return d * 1.01 if data.shape[1] == 39 or data.shape[1] == 900 \
                else d
        return dataset_distance_matrix
    return _patched(estimator, 'dataset_distance_matrix', make)


def _result(bench, tiny_configs, cell, seed=2 ** 31 + 9):
    import manifest
    cfg = tiny_configs[manifest.cell(bench, cell)['config']]
    return run.run_cell(cell, seed, 0.0, False, device='cpu', bench=bench,
                        config=cfg, limits=LIMITS)


@pytest.fixture(scope='module')
def sound(bench, tiny_configs):
    return {c: _result(bench, tiny_configs, c)
            for c in ('scglue.euclidean', 'scmnc_visual.geodesic')}


@pytest.mark.parametrize('fault,number', [
    (control.state_unchanged, 'dtheta'), (control.half_batch, 'loss'),
    (embedding_altered, 'embed'), (answer_altered, 'f'),
    (distances_altered, 'dist')])
@pytest.mark.parametrize('cell', ['scglue.euclidean',
                                  'scmnc_visual.geodesic'])
def test_fault_is_not_correct(fault, number, cell, bench, tiny_configs,
                              sound):
    assert sound[cell]['correct'] is True, sound[cell]['checks']
    with fault():
        broken = _result(bench, tiny_configs, cell)
    assert broken['correct'] is False
    c = broken['checks'][number]
    assert c['value'] > c['limit']
