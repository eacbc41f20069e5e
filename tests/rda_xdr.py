"""Builders of R's XDR serialization (RDX2/RDX3 streams) for the tests of
the `.rda` readers, and the writer of a motor-cortex-shaped `.rda` (the
`gdata` / `edata` / `meta` objects of motor_data_filtered.rda)."""

import gzip
import struct

import numpy as np


def u32(x):
    return struct.pack('>i', x)


def charsxp(s):
    b = s.encode()
    return u32(9 | (1 << 12)) + u32(len(b)) + b


def strsxp(strs, attr=b''):
    return (u32(16 | (0x200 if attr else 0)) + u32(len(strs))
            + b''.join(charsxp(s) for s in strs) + attr)


def realsxp(vals, attr=b''):
    out = u32(14 | (0x200 if attr else 0)) + u32(len(vals))
    return out + np.asarray(vals, '>f8').tobytes() + attr


def intsxp(vals, attr=b'', sexp=13):
    return (u32(sexp | (0x200 if attr else 0)) + u32(len(vals))
            + np.asarray(vals, '>i4').tobytes() + attr)


def vecsxp(items, attr=b''):
    return (u32(19 | (0x200 if attr else 0)) + u32(len(items))
            + b''.join(items) + attr)


def sym(name):
    return u32(1) + charsxp(name)


def pairlist(items):
    """Tagged pairlist of (name, encoded value) pairs."""
    return b''.join(u32(2 | 0x400) + sym(k) + v for k, v in items) + u32(254)


def stream(body, version=3):
    head = (b'RDX3\nX\n' + u32(3) + u32(0x30400) + u32(0x30000)
            + u32(5) + b'UTF-8') if version == 3 else (
        b'RDX2\nX\n' + u32(2) + u32(0x30400) + u32(0x20300))
    return head + body


def data_frame(columns, row_names):
    """A data.frame of {name: encoded column} with string row names."""
    return vecsxp(list(columns.values()), pairlist([
        ('names', strsxp(list(columns))),
        ('class', strsxp(['data.frame'])),
        ('row.names', strsxp(list(row_names)))]))


def write_motor_rda(path, counts, efeatures, efeature_names, cells,
                    families, meta_order=None):
    """A gzipped RDX3 `.rda` holding gdata (counts, genes x cells, with
    dimnames), edata (the e-features by cell, a data.frame) and meta (the
    cells' 'Cell' and 'RNA family', rows in meta_order)."""
    genes, n = counts.shape
    dimnames = vecsxp([strsxp([f'gene{j}' for j in range(genes)]),
                       strsxp(list(cells))])
    gdata = realsxp(counts.ravel(order='F'), pairlist([
        ('dim', intsxp([genes, n])), ('dimnames', dimnames)]))
    edata = data_frame({name: realsxp(efeatures[:, j])
                        for j, name in enumerate(efeature_names)}, cells)
    order = np.arange(n) if meta_order is None else meta_order
    meta = data_frame({'Cell': strsxp([cells[i] for i in order]),
                       'RNA family': strsxp([families[i] for i in order])},
                      [str(i + 1) for i in range(n)])
    body = pairlist([('gdata', gdata), ('edata', edata), ('meta', meta)])
    with open(path, 'wb') as fh:
        fh.write(gzip.compress(stream(body)))
