"""jamie_tpu_torch and chip_smoke.py import nothing of jax, flax, optax,
jamie_tpu, sklearn or umap (the card's machine has none of them), and the
port runs on the CPU only when asked to."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'jamie_tpu', 'sklearn', 'umap')


def _blocked(name: str) -> bool:
    # the exact name or a submodule: `jamie_tpu_torch` is not `jamie_tpu`
    return any(name == b or name.startswith(b + '.') for b in BLOCKED)


def test_blocker_rule():
    assert _blocked('jamie_tpu') and _blocked('jamie_tpu.ops')
    assert _blocked('jax.numpy') and not _blocked('jaxtyping')
    assert not _blocked('jamie_tpu_torch')
    assert _blocked('sklearn.metrics') and not _blocked('umap_learn_extra')
    assert not _blocked('jamie_tpu_torch.solvers.umap')


def test_import_with_jax_blocked():
    code = f'''
import sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
import importlib, pkgutil
import jamie_tpu_torch
for m in pkgutil.walk_packages(jamie_tpu_torch.__path__, 'jamie_tpu_torch.'):
    importlib.import_module(m.name)
from jamie_tpu_torch import JAMIE, ops, evaluation, persistence
from jamie_tpu_torch.models import convert
from jamie_tpu_torch.ops import distances
from jamie_tpu_torch.solvers import lowrank, prime_dual, tsne, umap
from jamie_tpu_torch.core import residency
from jamie_tpu_torch.config import DISTANCE_MODES
import numpy as np
import scipy.sparse
x = np.random.RandomState(0).rand(12, 5).astype('float32')
F = prime_dual.prime_dual(x @ x.T, x @ x.T, 5, 5, epoch_pd=3, verbose=False,
                          device='cpu')
residency.DeviceCSR(scipy.sparse.csr_matrix(x), 'cpu').tmatmul(x)
residency.device_bf16(x, device='cpu')
for mode in DISTANCE_MODES:
    distances.dataset_distance_matrix(x[:, :2] if mode == 'haversine' else x,
                                      mode, device='cpu')
tsne.tsne_embed(x, 2, perplexity=3, n_iters=5, device='cpu')
umap.umap_embed(x, 2, n_epochs=5, device='cpu')
lowrank.lowrank_corr(x @ x.T, x @ x.T, dim=3, epochs=3, device='cpu')
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED))
print('leaked', leaked, tuple(F.shape))
'''
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'leaked [] (12, 12)'


def _imported_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', sorted(
    str(p.relative_to(ROOT)) for p in
    [*ROOT.glob('jamie_tpu_torch/**/*.py'), ROOT / 'chip_smoke.py']))
def test_no_jax_imports_in_source(path):
    names = [n for n in _imported_names(ROOT / path) if _blocked(n)]
    assert not names, f'{path} imports {names}'


def test_no_device_and_no_cuda_raises(monkeypatch):
    from jamie_tpu_torch import JAMIE
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JAMIE()
    assert JAMIE(device='cpu').device == torch.device('cpu')
