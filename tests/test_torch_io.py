"""jamie_tpu_torch.io against jamie_tpu.io: every case of tests/test_io.py
run through both packages on the same handcrafted files (anndata's public
on-disk format, 10x CellRanger h5 and mtx layouts), compared exactly, plus
the formats load_matrix / load_labels read without h5py, and the named
ImportError when an optional package is missing."""

import gzip

import numpy as np
import pytest
from scipy import io as sio
from scipy import sparse

h5py = pytest.importorskip('h5py')

from jamie_tpu import io as jio  # noqa: E402
from jamie_tpu_torch import io as tio  # noqa: E402


def _write_csr(parent, name, mat, fmt='csr'):
    m = sparse.csr_matrix(mat) if fmt == 'csr' else sparse.csc_matrix(mat)
    g = parent.create_group(name)
    g.attrs['encoding-type'] = f'{fmt}_matrix'
    g.attrs['encoding-version'] = '0.1.0'
    g.attrs['shape'] = mat.shape
    g.create_dataset('data', data=m.data)
    g.create_dataset('indices', data=m.indices)
    g.create_dataset('indptr', data=m.indptr)


def _write_obs(f, cell_types):
    obs = f.create_group('obs')
    obs.attrs['encoding-type'] = 'dataframe'
    obs.attrs['_index'] = '_index'
    obs.create_dataset(
        '_index', data=[f'cell{i}'.encode() for i in range(len(cell_types))])
    cat = obs.create_group('cell_type')
    cat.attrs['encoding-type'] = 'categorical'
    cats = sorted(set(cell_types))
    cat.create_dataset('categories', data=[c.encode() for c in cats])
    cat.create_dataset('codes', data=[cats.index(c) for c in cell_types])
    obs.create_dataset('depth', data=np.arange(len(cell_types)) * 10.0)


def _make_h5ad(path, X, fmt='dense', cell_types=('a', 'b', 'a', 'b')):
    with h5py.File(path, 'w') as f:
        if fmt == 'dense':
            f.create_dataset('X', data=X)
        else:
            _write_csr(f, 'X', X, fmt)
        _write_obs(f, list(cell_types))
        var = f.create_group('var')
        var.attrs['_index'] = '_index'
        var.create_dataset(
            '_index', data=[f'g{j}'.encode() for j in range(X.shape[1])])
        var.create_dataset(
            'name', data=[f'gene{j}'.encode() for j in range(X.shape[1])])
        layers = f.create_group('layers')
        layers.create_dataset('doubled', data=X * 2)


def _make_10x_v3(path, X):
    csc = sparse.csc_matrix(X.T)            # genes x cells, CSC as 10x ships
    with h5py.File(path, 'w') as f:
        g = f.create_group('matrix')
        g.create_dataset('data', data=csc.data)
        g.create_dataset('indices', data=csc.indices)
        g.create_dataset('indptr', data=csc.indptr)
        g.create_dataset('shape', data=np.array(csc.shape))
        g.create_dataset(
            'barcodes', data=[f'BC{i}'.encode() for i in range(X.shape[0])])
        feats = g.create_group('features')
        feats.create_dataset(
            'name', data=[f'gene{j}'.encode() for j in range(X.shape[1])])


def _same(a, b):
    """Exact equality of two reader outputs: arrays (dtype included),
    scipy matrices (format, dtype, values), dicts, lists and tuples."""
    assert type(a).__name__ == type(b).__name__
    if hasattr(a, 'obs_names'):             # H5adData
        for k in ('X', 'obs_names', 'var_names', 'obs', 'var'):
            _same(getattr(a, k), getattr(b, k))
    elif sparse.issparse(a):
        assert a.format == b.format and a.dtype == b.dtype
        assert (a != b).nnz == 0
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _both(fn_name, *args, **kw):
    """The port's result, after checking it equals jamie_tpu's exactly."""
    ours = getattr(tio, fn_name)(*args, **kw)
    _same(ours, getattr(jio, fn_name)(*args, **kw))
    return ours


@pytest.fixture
def X():
    rng = np.random.RandomState(0)
    mat = rng.rand(4, 5).astype(np.float32)
    mat[mat < 0.4] = 0
    return mat


@pytest.mark.parametrize('fmt', ['dense', 'csr', 'csc'])
def test_read_h5ad_matrix_encodings(tmp_path, X, fmt):
    p = str(tmp_path / 'a.h5ad')
    _make_h5ad(p, X, fmt)
    ad = _both('read_h5ad', p)
    assert isinstance(ad, tio.H5adData)
    np.testing.assert_allclose(ad.X, X, rtol=1e-6)
    assert ad.X.dtype == np.float32
    assert list(ad.obs_names) == ['cell0', 'cell1', 'cell2', 'cell3']
    assert list(ad.var_names) == ['g0', 'g1', 'g2', 'g3', 'g4']
    assert list(ad.obs['cell_type']) == ['a', 'b', 'a', 'b']
    assert list(ad.var['name']) == [f'gene{j}' for j in range(5)]
    np.testing.assert_allclose(ad.obs['depth'], [0., 10., 20., 30.])
    assert repr(ad) == repr(jio.read_h5ad(p))


def test_read_h5ad_sparse_output_and_layer(tmp_path, X):
    p = str(tmp_path / 'a.h5ad')
    _make_h5ad(p, X, 'csc')
    ad = _both('read_h5ad', p, dense=False)
    assert hasattr(ad.X, 'toarray')
    np.testing.assert_allclose(ad.X.toarray(), X, rtol=1e-6)
    ad2 = _both('read_h5ad', p, layer='doubled')
    np.testing.assert_allclose(ad2.X, X * 2, rtol=1e-6)


def test_read_h5ad_legacy_record_obs(tmp_path, X):
    p = str(tmp_path / 'legacy.h5ad')
    with h5py.File(p, 'w') as f:
        f.create_dataset('X', data=X)
        rec = np.zeros(4, dtype=[('index', 'S8'), ('cell_type', 'S4')])
        rec['index'] = [f'c{i}'.encode() for i in range(4)]
        rec['cell_type'] = [b'x', b'y', b'x', b'y']
        f.create_dataset('obs', data=rec)
    ad = _both('read_h5ad', p)
    assert list(ad.obs_names) == ['c0', 'c1', 'c2', 'c3']
    assert list(ad.obs['cell_type']) == ['x', 'y', 'x', 'y']
    assert list(ad.var_names) == [0, 1, 2, 3, 4]


def test_read_h5ad_index_fallbacks(tmp_path, X):
    p = str(tmp_path / 'old.h5ad')
    with h5py.File(p, 'w') as f:
        f.create_dataset('X', data=X)
        obs = f.create_group('obs')
        obs.create_dataset('index', data=[f'c{i}'.encode() for i in range(4)])
        obs.create_dataset('score', data=np.arange(4.0))
    ad = _both('read_h5ad', p)
    assert list(ad.obs_names) == ['c0', 'c1', 'c2', 'c3']
    assert 'index' not in ad.obs and 'score' in ad.obs

    p2 = str(tmp_path / 'noindex.h5ad')
    with h5py.File(p2, 'w') as f:
        f.create_dataset('X', data=X)
        obs = f.create_group('obs')
        cat = obs.create_group('grp')
        cat.create_dataset('categories', data=[b'a', b'b'])
        cat.create_dataset('codes', data=[0, 1, 0, 1])
    ad2 = _both('read_h5ad', p2)
    assert list(ad2.obs_names) == [0, 1, 2, 3]
    assert list(ad2.obs['grp']) == ['a', 'b', 'a', 'b']


def test_read_h5ad_nan_code_and_column_filter(tmp_path, X):
    p = str(tmp_path / 'a.h5ad')
    _make_h5ad(p, X)
    with h5py.File(p, 'r+') as f:
        codes = f['obs/cell_type/codes']
        codes[1] = -1                       # pandas NaN category
    ad = _both('read_h5ad', p, obs_columns=['cell_type'])
    assert ad.obs['cell_type'][1] is None
    assert 'depth' not in ad.obs


def test_load_matrix_h5ad_path(tmp_path, X):
    p = str(tmp_path / 'a.h5ad')
    _make_h5ad(p, X, 'csr')
    out = _both('load_matrix', p)
    np.testing.assert_allclose(out, X, rtol=1e-6)
    assert out.dtype == np.float32


def test_read_10x_h5_v3(tmp_path, X):
    p = str(tmp_path / 'filtered.h5')
    _make_10x_v3(p, X)
    mat, barcodes, names = _both('read_10x_h5', p)
    np.testing.assert_allclose(mat, X, rtol=1e-6)   # back to cells x genes
    assert list(barcodes) == [f'BC{i}' for i in range(4)]
    assert list(names) == [f'gene{j}' for j in range(5)]


def _write_triplet(d, X, gz=True):
    """A 10x v3 mtx triplet of cells x genes X (stored genes x cells)."""
    op = gzip.open if gz else open
    sfx = '.gz' if gz else ''
    d.mkdir()
    with op(d / f'matrix.mtx{sfx}', 'wb') as fh:
        sio.mmwrite(fh, sparse.coo_matrix(X.T))
    with op(d / f'barcodes.tsv{sfx}', 'wt') as fh:
        fh.write(''.join(f'BC{i}\n' for i in range(X.shape[0])))
    with op(d / f'features.tsv{sfx}', 'wt') as fh:
        fh.write(''.join(f'ENSG{j}\tgene{j}\tGene Expression\n'
                         for j in range(X.shape[1])))


@pytest.mark.parametrize('gz', [True, False])
def test_read_10x_mtx_triplet(tmp_path, X, gz):
    d = tmp_path / 'filtered_feature_bc_matrix'
    _write_triplet(d, X, gz)
    mat, barcodes, names = _both('read_10x_mtx', str(d))
    assert mat.format == 'csr'
    np.testing.assert_allclose(mat.toarray(), X, rtol=1e-6)
    assert list(barcodes) == [f'BC{i}' for i in range(4)]
    assert list(names) == [f'gene{j}' for j in range(5)]
    dense, _, _ = _both('read_10x_mtx', str(d), dense=True)
    assert dense.dtype == np.float32


def test_read_10x_mtx_integer_counts_exact(tmp_path):
    """Integer counts (what CellRanger writes) come back exactly."""
    counts = np.random.RandomState(3).poisson(1.5, (30, 12)).astype(np.int64)
    d = tmp_path / 'counts'
    _write_triplet(d, counts)
    mat, _, _ = _both('read_10x_mtx', str(d))
    np.testing.assert_array_equal(mat.toarray(), counts)
    with pytest.raises(FileNotFoundError):
        tio.read_10x_mtx(str(tmp_path))


def test_read_10x_h5_v2_genome_group(tmp_path, X):
    csc = sparse.csc_matrix(X.T)
    p = str(tmp_path / 'v2.h5')
    with h5py.File(p, 'w') as f:
        g = f.create_group('GRCh38')
        g.create_dataset('data', data=csc.data)
        g.create_dataset('indices', data=csc.indices)
        g.create_dataset('indptr', data=csc.indptr)
        g.create_dataset('shape', data=np.array(csc.shape))
        g.create_dataset('barcodes', data=[b'B0', b'B1', b'B2', b'B3'])
        g.create_dataset('genes', data=[f'ENSG{j}'.encode() for j in range(5)])
        g.create_dataset(
            'gene_names', data=[f'gene{j}'.encode() for j in range(5)])
    mat, barcodes, names = _both('read_10x_h5', p, dense=False)
    np.testing.assert_allclose(mat.toarray(), X, rtol=1e-6)
    assert list(names) == [f'gene{j}' for j in range(5)]
    with h5py.File(p, 'r+') as f:
        f.create_group('mm10_dummy')['x'] = 1
    for pkg in (jio, tio):
        with pytest.raises(ValueError):
            pkg.read_10x_h5(p)
    mat2, _, _ = _both('read_10x_h5', p, genome='GRCh38')
    np.testing.assert_allclose(mat2, X, rtol=1e-6)


@pytest.mark.parametrize('ext', ['.npy', '.npz', '.txt', '.csv', '.mtx'])
def test_load_matrix_formats(tmp_path, X, ext):
    p = str(tmp_path / f'm{ext}')
    if ext == '.npy':
        np.save(p, X)
    elif ext == '.npz':
        np.savez(p, X)
    elif ext == '.txt':
        np.savetxt(p, X)
    elif ext == '.csv':
        with open(p, 'w') as fh:
            fh.write('cell,' + ','.join(f'g{j}' for j in range(5)) + '\n')
            for i, row in enumerate(X):
                fh.write(f'c{i},' + ','.join(repr(float(v)) for v in row)
                         + '\n')
    else:
        sio.mmwrite(p, sparse.coo_matrix(X))
    out = _both('load_matrix', p)
    np.testing.assert_allclose(out, X, rtol=1e-6)
    np.testing.assert_allclose(_both('load_matrix', p, transpose=True), X.T,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        tio.load_matrix(str(tmp_path / 'm.xyz'))


def test_load_matrix_mmap_keeps_stored_dtype(tmp_path, X):
    p = str(tmp_path / 'm.npy')
    np.save(p, X.astype(np.float64))
    with pytest.warns(UserWarning, match='stored dtype'):
        out = tio.load_matrix(p, mmap=True)
    assert isinstance(out, np.memmap) and out.dtype == np.float64
    _same(np.asarray(out), np.asarray(jio.load_matrix(p, mmap=True,
                                                      dtype=None)))


def test_load_labels(tmp_path):
    p = tmp_path / 'l.txt'
    p.write_text('1\n2\n2\n')
    _same(_both('load_labels', str(p)), np.array([1.0, 2.0, 2.0]))
    p = tmp_path / 's.txt'
    p.write_text('a\nb\n')
    _same(_both('load_labels', str(p)), np.array(['a', 'b']))
    p = tmp_path / 'l.csv'
    p.write_text('cell,type,stage\nc0,x,1\nc1,y,2\n')
    assert list(_both('load_labels', str(p))) == [1, 2]
    assert list(_both('load_labels', str(p), column='type')) == ['x', 'y']
    with pytest.raises(ValueError):
        tio.load_labels(str(tmp_path / 'l.json'))


@pytest.mark.parametrize('package, call', [
    ('h5py', lambda p: tio.read_h5ad(p + '.h5ad')),
    ('h5py', lambda p: tio.read_10x_h5(p + '.h5')),
    ('pandas', lambda p: tio.load_matrix(p + '.csv')),
    ('pandas', lambda p: tio.load_labels(p + '.csv')),
])
def test_missing_optional_package_names_it(tmp_path, monkeypatch, package,
                                           call):
    """The card's machine has neither h5py nor pandas: a reader that needs
    one raises ImportError naming the package and the function."""
    monkeypatch.setitem(__import__('sys').modules, package, None)
    with pytest.raises(ImportError, match=package) as e:
        call(str(tmp_path / 'missing'))
    assert 'read_' in str(e.value) or 'load_' in str(e.value)
