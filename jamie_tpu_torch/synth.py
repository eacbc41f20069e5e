"""Seeded synthetic data for the benchmark harnesses (`bench`,
`time_and_memory`, `probes`).

A copy of the repo's `examples/synth.py` and of `bench.py`'s SNARE-seq
generator, with the same numpy draws in the same order, so the arrays are
bit-equal to the ones `jamie_tpu`'s harnesses fit. Generation stays on the
host in numpy: data made on the card would differ from theirs.

- `make_snare_like`: SNARE-seq-shaped pair (1047 cells, 3000 RNA / 5000
  binary ATAC features, 4 clusters), with its labels;
- `synthesize`: a rank-`latent` pair at any published shape, the ATAC arm
  optionally binary peaks z-scored per column (`binarize1`);
- `synthesize_sparse_pair`: a counts-like CSR pair over a 12-cluster
  latent, with `synthesize_sparse_labels` for its labels.

`cache=True` keeps the arrays under `SYNTH_CACHE` (memmap-loaded on a
rerun), `cache=False` generates in memory and writes nothing, and a path
caches there instead.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Union

import numpy as np

SYNTH_CACHE = os.path.expanduser('~/.cache/jamie_tpu_torch_bench')


def _cache_dir(cache: Union[bool, str]):
    """The directory `cache` names, or None for in-memory generation."""
    if cache is True:
        return SYNTH_CACHE
    return os.fspath(cache) if cache else None


def make_snare_like(n=1047, d_rna=3000, d_atac=5000, seed=0):
    """SNARE-seq-shaped paired data (cell lines, ~1k cells): a
    16-dimensional latent around 4 cluster centres; RNA relu(z W + 0.5
    noise), ATAC 0/1 at (z W + 0.5 noise) > 0.5. Returns ([rna, atac],
    labels)."""
    rng = np.random.RandomState(seed)
    k = 16
    z = rng.randn(n, k).astype(np.float32)
    centers = rng.randn(4, k).astype(np.float32) * 2
    assign = rng.randint(0, 4, n)
    z += centers[assign]
    x_rna = np.maximum(z @ rng.randn(k, d_rna).astype(np.float32)
                       + 0.5 * rng.randn(n, d_rna).astype(np.float32), 0)
    x_atac = (z @ rng.randn(k, d_atac).astype(np.float32)
              + 0.5 * rng.randn(n, d_atac).astype(np.float32) > 0.5
              ).astype(np.float32)
    return [x_rna, x_atac], assign


def synthesize(shape0, shape1, seed=0, latent=32, binarize1=None,
               cache: Union[bool, str] = True):
    """Spectrum-matched synthetic pair at the given shapes.

    The noise is generated in 16,384-column chunks, so a 241,757-column
    modality stays memory- and time-bounded; each chunk's binarization
    runs on a worker thread while the next chunk is drawn (the draws stay
    in order, so the arrays are the same). binarize1: if set (a density
    in (0, 1)), modality 1 models binary ATAC peaks as the reference's
    notebooks feed them to JAMIE: thresholded to {0, 1} at the per-column
    (1 - density) quantile, then z-scored per column (dense, two-valued
    per column). Cached under a distinct filename; modality 0's cache is
    shared with the continuous variant. Consumers treat the arrays as
    read-only (fit_transform never mutates its inputs)."""
    directory = _cache_dir(cache)
    paths = None
    if directory is not None:
        tags = ['', f'_zb{int(binarize1 * 100)}' if binarize1 else '']
        paths = [os.path.join(directory,
                              f'tm_{s[0]}x{s[1]}_{seed}_{i}{tags[i]}.npy')
                 for i, s in enumerate((shape0, shape1))]
        if all(os.path.exists(p) for p in paths):
            return [np.load(p, mmap_mode='r') for p in paths]

    rng = np.random.default_rng(seed)   # PCG64
    n = shape0[0]
    z = rng.standard_normal((n, latent), dtype=np.float32)

    def binarized(block, density):
        tau = np.quantile(block, 1.0 - density, axis=0)
        b = (block > tau).astype(np.float32)
        mu, sd = b.mean(axis=0), b.std(axis=0)
        block[...] = (b - mu) / np.where(sd == 0, 1.0, sd)

    def one(shape, binarize=None, pool=None):
        out = np.empty((n, shape[1]), np.float32)
        chunk = 16384
        jobs = []
        for s in range(0, shape[1], chunk):
            e = min(s + chunk, shape[1])
            w = rng.standard_normal((latent, e - s), dtype=np.float32)
            out[:, s:e] = z @ w
            out[:, s:e] += 0.3 * rng.standard_normal((n, e - s),
                                                     dtype=np.float32)
            if binarize is not None:
                # the per-column quantile and scaling draw nothing from
                # rng, so they run beside the next chunk's draws
                jobs.append(pool.submit(binarized, out[:, s:e], binarize))
        for job in jobs:
            job.result()
        return out

    with ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1)) as pool:
        data = [one(shape0), one(shape1, binarize1, pool)]
    if paths is not None:
        try:
            os.makedirs(directory, exist_ok=True)
            for p, d in zip(paths, data):
                np.save(p + '.tmp.npy', d)
                os.replace(p + '.tmp.npy', p)
        except OSError:
            pass   # no disk room: run uncached
    return data


def _sparse_latent(n, seed, latent):
    """The shared clustered latent behind synthesize_sparse_pair, plus the
    cluster assignments. The draw order is load-bearing: z, then centers,
    then assignments, then (in the pair generator) per-modality weights,
    so labels can be re-derived for a cached pair without regenerating the
    matrices."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, latent), dtype=np.float32)
    centers = 2.0 * rng.standard_normal((12, latent), dtype=np.float32)
    assign = rng.integers(0, 12, n)
    z += centers[assign]
    return z, assign, rng


def synthesize_sparse_labels(n, seed=0, latent=24):
    """Cluster labels of the synthesize_sparse_pair latent (the same draws,
    stopping before the weights)."""
    return _sparse_latent(n, seed, latent)[1]


def synthesize_sparse_pair(n, d0, d1, density=0.03, seed=0, latent=24,
                           cache: Union[bool, str] = True):
    """Counts-like sparse CSR modality pair over a shared clustered latent
    (the 10x-multiome shape class: tall, nonnegative, a few % nonzero).

    Row-chunked generation (the dense matrix never exists), with a
    per-modality cutoff calibrated on the first chunk to hit the target
    density. Cached as .npz (scipy save_npz) beside the dense caches."""
    from scipy import sparse

    directory = _cache_dir(cache)
    paths = None
    if directory is not None:
        paths = [os.path.join(directory,
                              f'sp_{n}x{d}_{density}_{seed}_{i}.npz')
                 for i, d in enumerate((d0, d1))]
        if all(os.path.exists(p) for p in paths):
            return [sparse.load_npz(p) for p in paths]

    z, _assign, rng = _sparse_latent(n, seed, latent)

    def one(d):
        w = rng.standard_normal((latent, d), dtype=np.float32)
        chunk = max(int((1 << 29) / (d * 4)), 256)
        first = z[:chunk] @ w + 0.3 * rng.standard_normal(
            (min(chunk, n), d), dtype=np.float32)
        cutoff = np.quantile(first, 1.0 - density)
        blocks = []
        for s in range(0, n, chunk):
            xb = z[s:s + chunk] @ w
            xb += 0.3 * rng.standard_normal(xb.shape, dtype=np.float32)
            xb -= cutoff
            np.maximum(xb, 0.0, out=xb)   # relu at the density cutoff
            blocks.append(sparse.csr_matrix(xb))
        return sparse.vstack(blocks, format='csr')

    data = [one(d0), one(d1)]
    if paths is not None:
        try:
            os.makedirs(directory, exist_ok=True)
            for p, m in zip(paths, data):
                sparse.save_npz(p + '.tmp', m)
                os.replace(p + '.tmp.npz', p)
        except OSError:
            pass
    return data
