"""The benchmark's own modules and the program's package on the path, and
a tiny configuration of each cell for CPU runs."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny(config: dict, n: int = 150, epochs: int = 30) -> dict:
    """The configuration at a size a CPU test holds: n cells, narrow
    arms, a short schedule; the same kwargs otherwise."""
    cfg = copy.deepcopy(config)
    wide = cfg['name'] == 'scglue'
    cfg['shapes'] = [[n, 300], [n, 900 if wide else 39]]
    cfg['latent'] = 8
    cfg['kwargs'].update(epoch_pd=30, epoch_DNN=epochs, batch_size=64,
                         pca_dim=[32, 32])
    # under 100M elements the port's distances and PCA stay float32
    cfg['precision'].update(distances='float32', pca='float32')
    return cfg


@pytest.fixture(scope='session')
def bench():
    import manifest
    return manifest.load()


@pytest.fixture(scope='session')
def tiny_configs(bench):
    import manifest
    return {c['name']: tiny(manifest.config(bench, c['name']))
            for c in bench['configs']}
