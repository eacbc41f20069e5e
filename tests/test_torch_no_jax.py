"""jamie_tpu_torch and chip_smoke.py import nothing of jax, flax, optax,
jamie_tpu, sklearn or umap (the card's machine has none of them), nor does
the device mesh (core/mesh.py, multichip.py) at world size 1, the port
runs without h5py, pandas, matplotlib, seaborn and shap (optional: only the
readers, the plots and the shap route that need one import it), and the
port runs on the CPU only when asked to."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'jamie_tpu', 'sklearn', 'umap')
# optional packages the card's machine lacks: never loaded by importing or
# running the port's workflow (readers of other formats, plots and the shap
# package's route import them inside the function that needs them)
OPTIONAL = ('h5py', 'pandas', 'matplotlib', 'seaborn', 'shap')


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
BLOCKED = {BLOCKED + OPTIONAL!r}
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
# the raw-file workflow: read, normalize, fit, explain
import os, tempfile
from scipy import io as sio
from jamie_tpu_torch import io, normalize, rdata
from jamie_tpu_torch.evaluation import (ShapValues, evaluate_impact,
    kernel_shap, occlusion_impact_device, shap_explain, test_partial)
tmp = tempfile.mkdtemp()
counts = np.random.RandomState(1).poisson(2.0, (24, 6))
sio.mmwrite(os.path.join(tmp, 'matrix.mtx'), scipy.sparse.coo_matrix(counts.T))
open(os.path.join(tmp, 'barcodes.tsv'), 'w').write('b\\n' * 24)
open(os.path.join(tmp, 'features.tsv'), 'w').write('g\\tG\\n' * 6)
X = normalize.normalize_log_cpm(io.read_10x_mtx(tmp)[0]).astype('float32')
for fn, arg in ((io.read_h5ad, 'a.h5ad'), (io.load_labels, 'a.csv')):
    try:
        fn(os.path.join(tmp, arg))
    except ImportError as e:
        assert 'h5py' in str(e) or 'pandas' in str(e), e
try:
    rdata.load_rda(os.path.join(tmp, 'barcodes.tsv'))
except ValueError:
    pass
data = [X.toarray(), np.random.RandomState(2).rand(24, 4).astype('float32')]
kw = dict(device='cpu', epoch_DNN=2, pca_dim=None, use_f_tilde=False,
          dropout=0.0, batch_size=12, log_DNN=100)
jm = JAMIE(**kw)
jm.fit_transform(dataset=data)
occlusion_impact_device(jm, data[0], data[1], batch_features=4)
assert isinstance(shap_explain(jm, data[0][:2], max_evals=16), ShapValues)
evaluate_impact(lambda d, idx=None: d.sum(1), lambda a, b: float(a.mean()),
                data[0], None)
test_partial(data, [np.arange(24) % 2] * 2, fraction_range=(0, 1),
             plot=False, **kw)
# the analysis and baseline modules: the numeric functions, no plotting
import torch
from jamie_tpu_torch import compare, figures, nn_funcs, utils
from jamie_tpu_torch.models import baselines
labels = [np.arange(24) % 2] * 2
res = compare.compare_methods(data, labels, methods=('NLMA', 'CCA'),
                              output_dim=2, device='cpu')
assert all(np.isfinite(r['foscttm']) for r in res.values())
utils.predict_knn(data[0], data[1], k=3, device='cpu')
baselines.predict_nn(data[0], data[1], epochs=2, batch_size=8, device='cpu')
figures.silhouette_samples(data[1], labels[0], device='cpu')
figures.imputation_feature_scores(data[1], data[1])
nn_funcs.knn_dist(data[1], device='cpu')
e = torch.tensor(data[1], requires_grad=True)
nn_funcs.gw_loss([e, torch.tensor(data[1][::-1].copy())]).backward()
assert bool(torch.isfinite(e.grad).all())
# the device mesh at world size 1 (gloo): distances, solver, fit, entry
from jamie_tpu_torch import multichip
from jamie_tpu_torch.core import mesh as cm
mesh = cm.create_mesh((1,), device_type='cpu')
distances.pairwise_distance(x, 'cosine', device='cpu', mesh=mesh)
prime_dual.prime_dual(x @ x.T, x @ x.T, 5, 5, epoch_pd=3, verbose=False,
                      device='cpu', mesh=mesh)
JAMIE(mesh=mesh, **kw).fit_transform(dataset=data)
fn, args = multichip.entry()
fn(*args)
cm.destroy_group()
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


# The harnesses keep their own copies of the repo's bench.py,
# examples/synth.py and examples/time_and_memory.py: none imports them
HARNESSES = ('jamie_tpu_torch/bench.py', 'jamie_tpu_torch/synth.py',
             'jamie_tpu_torch/time_and_memory.py')
HARNESS_BLOCKED = ('bench', 'synth', 'examples', 'time_and_memory')


@pytest.mark.parametrize('path', HARNESSES)
def test_harnesses_import_no_jax_side_harness(path):
    names = list(_imported_names(ROOT / path))
    assert not [n for n in names if _blocked(n) or any(
        n == b or n.startswith(b + '.') for b in HARNESS_BLOCKED)], names


def test_harnesses_run_with_jax_and_examples_blocked():
    # a blocked module has a spec whose loader refuses it: importing it
    # raises, while importlib.util.find_spec (which torch's flop counter
    # calls on optional packages) still returns
    code = f'''
import importlib.machinery, sys
BLOCKED = {BLOCKED + HARNESS_BLOCKED!r}
class Refuse:
    def create_module(self, spec):
        raise ImportError('blocked ' + spec.name)
    def exec_module(self, module):
        pass
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            return importlib.machinery.ModuleSpec(name, Refuse())
sys.meta_path.insert(0, Block())
for name in BLOCKED:
    try:
        __import__(name)
        raise SystemExit(name + ' imported')
    except ImportError:
        pass
from jamie_tpu_torch import bench, synth, time_and_memory
data = synth.make_snare_like(n=40, d_rna=20, d_atac=30)[0]
rec = bench.train_leg(data=data, pca_dim=8, epoch_chunk=1, timed_chunks=1,
                      device='cpu')
res = time_and_memory.run_config('t', (40, 12), (40, 9), 1.0, epoch_dnn=1,
                                 min_epochs=0, device='cpu', cache=False)
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED))
print('leaked', leaked, rec['value'] > 0, res['epochs_run'])
'''
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'leaked [] True 1'


@pytest.mark.parametrize('entry', ['bench.main', 'bench.train_leg',
                                   'time_and_memory.run_config',
                                   'time_and_memory.main'])
def test_harness_entry_points_need_the_card(monkeypatch, entry):
    """Without CUDA the harnesses raise before any work, unless the caller
    passes device='cpu'."""
    import importlib
    mod_name, fn_name = entry.split('.')
    mod = importlib.import_module(f'jamie_tpu_torch.{mod_name}')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    called = []
    monkeypatch.setattr(mod, 'synthesize',
                        lambda *a, **k: called.append(1) or [])
    args = {'bench.main': (), 'bench.train_leg': (),
            'time_and_memory.run_config': ('t', (4, 2), (4, 2), 1.0),
            'time_and_memory.main': ([],)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(mod, fn_name)(*args)
    assert not called
