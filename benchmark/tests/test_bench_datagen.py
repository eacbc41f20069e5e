"""The benchmark's data generator: shapes, seeding, the binary arm's
density, the standardization, and nothing written to disk."""

import os

import torch

import datagen


def _config(density=None):
    return {'shapes': [[400, 70], [400, 20000]], 'density': [None, density],
            'zscore': [True, True], 'latent': 8, 'noise': 0.3}


def test_shapes_dtype_and_seed():
    a = datagen.make_pair(_config(), 2 ** 31 + 11, 'cpu')
    b = datagen.make_pair(_config(), 2 ** 31 + 11, 'cpu')
    c = datagen.make_pair(_config(), 2 ** 31 + 12, 'cpu')
    assert [tuple(x.shape) for x in a] == [(400, 70), (400, 20000)]
    assert all(x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])


def test_binary_arm_density_and_zscore():
    x = datagen.make_pair(_config(0.05), 3, 'cpu')[1]
    # two values per column, z-scored: the share above the mean is the
    # share of 1s, 20 of 400 at the interpolated 0.95 quantile
    ones = (x > 0).float().mean(0)
    assert torch.allclose(ones, torch.full_like(ones, 20 / 400))
    assert all(len(torch.unique(x[:, j])) == 2 for j in range(0, 20000, 997))
    assert torch.allclose(x.mean(0), torch.zeros(20000), atol=1e-5)
    assert torch.allclose(x.std(0, correction=0), torch.ones(20000),
                          atol=1e-4)


def test_continuous_arm_is_standardized_and_low_rank():
    x = datagen.make_pair(_config(), 5, 'cpu')[0]
    assert torch.allclose(x.mean(0), torch.zeros(70), atol=1e-5)
    s = torch.linalg.svdvals(x - x.mean(0))
    # rank-8 signal well above the noise floor
    assert s[7] > 5 * s[8]


def test_writes_nothing(tmp_path, monkeypatch):
    for var in ('HOME', 'TMPDIR', 'XDG_CACHE_HOME'):
        monkeypatch.setenv(var, str(tmp_path / var))
    monkeypatch.chdir(tmp_path)
    datagen.make_pair(_config(0.05), 1, 'cpu')
    assert os.listdir(tmp_path) == []
