"""jamie_tpu_torch.config against jamie_tpu.config: same fields, defaults,
validation and cache keys."""

import dataclasses
import warnings

import pytest

from jamie_tpu import config as jcfg
from jamie_tpu_torch import config as tcfg


def test_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.JamieConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.JamieConfig)]
    assert tf == jf
    assert tcfg.DISTANCE_MODES == jcfg.DISTANCE_MODES
    assert tcfg.SAMPLING_METHODS == jcfg.SAMPLING_METHODS


@pytest.mark.parametrize('kwargs', [
    {},
    {'epoch_DNN': 400, 'pca_dim': [20, 10]},
    {'loss_weights': [1, 2, 3, 4], 'distance_mode': 'euclidean'},
    {'debug': True, 'checkpoint_dir': '/x', 'solver_dtype': 'float32'},
])
def test_cache_key_identical(kwargs):
    shapes = [(120, 40), (120, 25)]
    assert (tcfg.JamieConfig(**kwargs).cache_key('pair', shapes)
            == jcfg.JamieConfig(**kwargs).cache_key('pair', shapes))


@pytest.mark.parametrize('bad', [
    {'integration_type': 'x'}, {'distance_mode': 'nope'},
    {'project_mode': 'x'}, {'model_pca': 'x'}, {'corr_method': 'x'},
])
def test_validation_matches(bad):
    with pytest.raises(ValueError):
        jcfg.JamieConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.JamieConfig(**bad)


def test_config_from_kwargs_alias_and_unknown():
    kwargs = dict(lr=0.01, epoch_dnn=5, beta=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        c = tcfg.config_from_kwargs(**kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        j = jcfg.config_from_kwargs(**kwargs)
    assert c.model_lr == 0.01
    assert dataclasses.asdict(c) == dataclasses.asdict(j)
    assert any('epoch_dnn' in str(w.message) for w in caught)
    assert not any('beta' in str(w.message) for w in caught)
