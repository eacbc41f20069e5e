"""Dataset IO helpers.

A copy of `jamie_tpu/io.py` (this package imports nothing of `jamie_tpu`):
`.txt/.csv/.npy/.npz/.h5ad/.mtx` matrices through one `load_matrix` (with
memory-mapped `.npy` so atlas-scale matrices stream from disk), `.h5ad`
files natively through h5py (`read_h5ad`: `X` dense or CSR/CSC, `layers`,
obs/var dataframes incl. categoricals, anndata format versions 0.7 to
0.10), 10x Genomics CellRanger `.h5` matrices (`read_10x_h5`, v2 genome
groups and the v3 `matrix` group), mtx triplet directories
(`read_10x_mtx`, scipy only) and label vectors (`load_labels`).

h5py and pandas are optional: each is imported by the function that needs
it, and its absence raises an ImportError naming the package and the
function (`.h5ad` and `.h5` files need h5py; `.csv` needs pandas).
"""

from __future__ import annotations

import importlib
import os
from typing import Optional

import numpy as np


def _optional(package: str, needed_by: str):
    """Import an optional dependency, or raise naming who needs it."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f'{needed_by} needs the {package!r} package, '
                          'which is not installed') from e


def load_matrix(path: str, transpose: bool = False, mmap: bool = False,
                dtype=np.float32) -> np.ndarray:
    """Load a cells x features matrix from .txt/.csv/.npy/.npz/.h5ad/.mtx."""
    ext = os.path.splitext(path)[1].lower()
    if ext == '.npy':
        out = np.load(path, mmap_mode='r' if mmap else None)
    elif ext == '.npz':
        with np.load(path) as z:
            out = z[z.files[0]]
    elif ext in ('.txt', '.tsv'):
        out = np.loadtxt(path)
    elif ext == '.csv':
        pd = _optional('pandas', "load_matrix('.csv')")
        df = pd.read_csv(path, index_col=0)
        out = df.to_numpy()
    elif ext == '.h5ad':
        out = read_h5ad(path).X
        if hasattr(out, 'toarray'):
            out = out.toarray()
    elif ext == '.mtx':
        from scipy.io import mmread
        out = mmread(path).toarray()
    else:
        raise ValueError(f'unsupported matrix format: {ext}')
    if transpose:
        out = out.T
    if mmap and isinstance(out, np.memmap):
        # Casting would materialize the whole matrix in RAM, defeating the
        # point of mmap — return the stored dtype and say so rather than
        # silently ignoring the requested one.
        if dtype is not None and out.dtype != np.dtype(dtype):
            import warnings
            warnings.warn(
                f'load_matrix(mmap=True): returning stored dtype '
                f'{out.dtype} (casting to {np.dtype(dtype)} would load the '
                'matrix into RAM); pass dtype=None to silence.', UserWarning)
        return out
    return np.asarray(out).astype(dtype, copy=False)


def _decode(arr) -> np.ndarray:
    """HDF5 string data arrives as bytes; hand callers str."""
    arr = np.asarray(arr)
    if arr.dtype.kind == 'S' or (arr.dtype == object and arr.size
                                 and isinstance(arr.flat[0], bytes)):
        return np.array([x.decode() for x in arr.ravel()]).reshape(arr.shape)
    return arr


def _read_sparse_group(group, dense: bool):
    """CSR/CSC group (data/indices/indptr) -> dense ndarray or scipy matrix."""
    enc = group.attrs.get('encoding-type',
                          group.attrs.get('h5sparse_format', ''))
    if isinstance(enc, bytes):
        enc = enc.decode()
    shape = tuple(group.attrs.get('shape',
                                  group.attrs.get('h5sparse_shape')))
    from scipy import sparse
    cls = sparse.csr_matrix if enc.startswith('csr') else sparse.csc_matrix
    mat = cls((group['data'][()], group['indices'][()],
               group['indptr'][()]), shape=shape)
    return mat.toarray() if dense else mat.tocsr()


def _read_matrix_node(node, dense: bool):
    h5py = _optional('h5py', 'read_h5ad')
    if isinstance(node, h5py.Dataset):
        return node[()]
    return _read_sparse_group(node, dense)


def _read_column(node):
    """One dataframe column: plain dataset, categorical group, or the
    nullable integer/boolean group encoding (values + mask)."""
    h5py = _optional('h5py', 'read_h5ad')
    if isinstance(node, h5py.Dataset):
        return _decode(node[()])
    if 'categories' in node and 'codes' in node:
        cats = _decode(node['categories'][()])
        codes = node['codes'][()]
        out = np.empty(codes.shape, dtype=object)
        valid = codes >= 0
        out[valid] = cats[codes[valid]]
        out[~valid] = None
        return out
    if 'values' in node:
        vals = _decode(node['values'][()])
        if 'mask' in node:
            vals = np.where(node['mask'][()], None, vals.astype(object))
        return vals
    raise ValueError(f'unrecognized h5ad column encoding at {node.name}')


def _read_dataframe(node, columns=None):
    """obs/var node -> (index array, {column: values}).

    Handles the group encoding (anndata >= 0.7: `_index` attr names the
    index dataset) and the legacy single compound-dtype dataset.
    """
    h5py = _optional('h5py', 'read_h5ad')
    if isinstance(node, h5py.Dataset):        # legacy record array
        rec = node[()]
        names = list(rec.dtype.names or ())
        idx_name = ('index' if 'index' in names
                    else '_index' if '_index' in names else None)
        index = (_decode(rec[idx_name]) if idx_name
                 else np.arange(len(rec)))
        wanted = columns if columns is not None else [
            n for n in names if n != idx_name]
        return index, {c: _decode(rec[c]) for c in wanted if c in names}
    idx_name = node.attrs.get('_index', '_index')
    if isinstance(idx_name, bytes):
        idx_name = idx_name.decode()
    if idx_name not in node and 'index' in node:
        idx_name = 'index'      # pre-0.7 files name it without the attr
    if idx_name in node:
        index = _decode(node[idx_name][()])
    else:
        def _col_len(x):  # categorical groups: row count lives in codes
            return len(x['codes']) if hasattr(x, 'keys') and 'codes' in x \
                else len(x)
        lengths = [_col_len(node[k]) for k in node.keys()
                   if not k.startswith('__')]
        index = np.arange(lengths[0] if lengths else 0)
    wanted = columns if columns is not None else [
        k for k in node.keys() if k != idx_name and k != '__categories']
    cols = {}
    for c in wanted:
        if c in node:
            cols[c] = _read_column(node[c])
    return index, cols


class H5adData:
    """What `read_h5ad` returns: the slice of an AnnData object the JAMIE
    pipeline consumes (scGLUE.ipynb cell 3 / scMNC-Visual.ipynb cell 3).

    Attributes: X (ndarray, or scipy CSR when dense=False), obs_names,
    var_names, obs (dict of per-cell columns), var (dict of per-feature
    columns). shape follows X.
    """

    def __init__(self, X, obs_names, var_names, obs, var):
        self.X, self.obs_names, self.var_names = X, obs_names, var_names
        self.obs, self.var = obs, var

    @property
    def shape(self):
        return self.X.shape

    def __repr__(self):
        return (f'H5adData(shape={self.shape}, obs={sorted(self.obs)}, '
                f'var={sorted(self.var)})')


def read_h5ad(path: str, layer: Optional[str] = None, dense: bool = True,
              obs_columns=None, var_columns=None,
              dtype=np.float32) -> H5adData:
    """Read an AnnData `.h5ad` file through h5py alone.

    Covers the on-disk encodings anndata 0.7-0.10 writes for the pieces a
    JAMIE workflow needs: `X` (or `layers/<layer>`) as a dense dataset or
    CSR/CSC group, obs/var as group dataframes (categorical, nullable, and
    plain columns) or the legacy record-array dataset. Everything else in
    the file (obsm/varm/uns/obsp) is ignored.

    dense=False returns X as scipy CSR when the file stores it sparse
    (files that store X dense return the ndarray either way — it is
    already materialized); sparse X keeps its stored dtype, the pipeline
    casts blockwise. JAMIE.fit_transform accepts both.
    """
    h5py = _optional('h5py', 'read_h5ad')
    with h5py.File(path, 'r') as f:
        node = f['layers'][layer] if layer is not None else f['X']
        X = _read_matrix_node(node, dense)
        if dtype is not None and isinstance(X, np.ndarray):
            X = X.astype(dtype, copy=False)
        obs_names, obs = (_read_dataframe(f['obs'], obs_columns)
                          if 'obs' in f else (np.arange(X.shape[0]), {}))
        var_names, var = (_read_dataframe(f['var'], var_columns)
                          if 'var' in f else (np.arange(X.shape[1]), {}))
    return H5adData(X, obs_names, var_names, obs, var)


def read_10x_h5(path: str, genome: Optional[str] = None,
                dense: bool = True, dtype=np.float32):
    """Read a 10x Genomics CellRanger `.h5` count matrix.

    Supports the v3 layout (one `matrix` group; feature names under
    `matrix/features/name`) and the v2 layout (one group per genome with
    `genes`/`gene_names`). 10x stores genes x cells CSC; the same
    data/indices/indptr reinterpreted as CSR is the cells x genes
    transpose, so no conversion pass is needed. Returns
    (X cells x genes, barcodes, gene_names).
    """
    h5py = _optional('h5py', 'read_10x_h5')
    from scipy import sparse
    with h5py.File(path, 'r') as f:
        if 'matrix' in f:
            g = f['matrix']
            names = _decode(g['features/name'][()])
        else:
            keys = [k for k in f.keys()]
            if genome is None:
                if len(keys) != 1:
                    raise ValueError(
                        f'multiple genomes {keys}; pass genome=')
                genome = keys[0]
            g = f[genome]
            names = _decode(g['gene_names'][()])
        barcodes = _decode(g['barcodes'][()])
        n_genes, n_cells = g['shape'][()]
        X = sparse.csr_matrix(
            (g['data'][()], g['indices'][()], g['indptr'][()]),
            shape=(n_cells, n_genes))
    if dense:
        X = X.toarray()
        if dtype is not None:
            X = X.astype(dtype, copy=False)
    return X, barcodes, names


def read_10x_mtx(directory: str, dense: bool = False, dtype=np.float32):
    """Read a 10x CellRanger mtx triplet directory: matrix.mtx[.gz] +
    features.tsv[.gz] (v3; genes.tsv in v2) + barcodes.tsv[.gz].

    The mtx is genes x cells COO; returns (X cells x genes as CSR — or
    dense when asked, barcodes, gene_names)."""
    import gzip

    from scipy import io as sio

    def _find(*names):
        for name in names:
            for suffix in ('', '.gz'):
                p = os.path.join(directory, name + suffix)
                if os.path.exists(p):
                    return p
        raise FileNotFoundError(
            f'none of {names} (or .gz) under {directory}')

    def _open(path, mode='rt'):
        return gzip.open(path, mode) if path.endswith('.gz') \
            else open(path, mode.replace('t', ''))

    with _open(_find('matrix.mtx'), 'rb') as fh:
        X = sio.mmread(fh).T.tocsr()          # -> cells x genes
    with _open(_find('barcodes.tsv')) as fh:
        barcodes = np.array([line.split('\t')[0].strip() for line in fh])
    with _open(_find('features.tsv', 'genes.tsv')) as fh:
        # column 2 is the gene symbol in both v2 and v3 triplets
        names = np.array([line.rstrip('\n').split('\t')[1]
                          if '\t' in line else line.strip() for line in fh])
    if dense:
        X = X.toarray().astype(dtype, copy=False)
    return X, barcodes, names


def load_labels(path: str, column: Optional[str] = None) -> np.ndarray:
    """Load a per-cell label vector from .txt/.csv."""
    ext = os.path.splitext(path)[1].lower()
    if ext in ('.txt', '.tsv'):
        try:
            return np.loadtxt(path)
        except ValueError:
            return np.loadtxt(path, dtype=str)
    if ext == '.csv':
        pd = _optional('pandas', "load_labels('.csv')")
        df = pd.read_csv(path)
        col = column if column is not None else df.columns[-1]
        return df[col].to_numpy()
    raise ValueError(f'unsupported label format: {ext}')
