"""jamie_tpu_torch.rdata against jamie_tpu.rdata: the cases of
tests/test_rdata.py through both packages, compared exactly, on hand-built
RDX2/RDX3 XDR streams (gzipped and plain)."""

import gzip
import os

import numpy as np
import pytest

from jamie_tpu import rdata as jrd
from jamie_tpu_torch import rdata as trd
from rda_xdr import intsxp, pairlist, realsxp, stream, strsxp, u32
from test_rdata import MOTOR   # the reference's motor .rda, where mounted


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _both(path):
    ours = trd.load_rda(path)
    _same(ours, jrd.load_rda(path))
    return ours


@pytest.mark.skipif(not os.path.exists(MOTOR), reason='reference mount absent')
def test_load_motor_rda():
    d = _both(MOTOR)
    assert set(d) >= {'gdata', 'edata', 'meta'}
    assert d['gdata']['matrix'].shape == (1286, 1208)


def test_load_rda_roundtrip_types(tmp_path):
    """Real vector with dim, and a string vector (tests/test_rdata.py)."""
    dim_attr = pairlist([('dim', intsxp([2, 3]))])
    body = pairlist([('m', realsxp([1, 2, 3, 4, 5, 6], dim_attr)),
                     ('s', strsxp(['a', 'b']))])
    p = tmp_path / 'toy.rda'
    p.write_bytes(gzip.compress(stream(body)))
    d = _both(str(p))
    np.testing.assert_allclose(d['m'], np.array([[1, 3, 5], [2, 4, 6]]))
    assert d['s'] == ['a', 'b']


def test_load_rda_factor_dataframe_dimnames(tmp_path):
    """A data.frame with a factor column and a logical column, and a
    matrix with dimnames, in an uncompressed RDX2 stream."""
    factor = intsxp([1, 2, 1, -2147483648], pairlist([
        ('levels', strsxp(['lo', 'hi'])), ('class', strsxp(['factor']))]))
    frame = (u32(19 | 0x200) + u32(2) + factor
             + intsxp([1, 0, 1, 1], sexp=10)
             + pairlist([('names', strsxp(['grp', 'flag'])),
                         ('class', strsxp(['data.frame'])),
                         ('row.names', intsxp([1, 2, 3, 4]))]))
    dimnames = u32(19) + u32(2) + strsxp(['r1', 'r2']) + strsxp(['c1'])
    mat = realsxp([0.5, 1.5], pairlist([('dim', intsxp([2, 1])),
                                        ('dimnames', dimnames)]))
    p = tmp_path / 'frame.RData'
    p.write_bytes(stream(pairlist([('df', frame), ('mat', mat)]), version=2))
    d = _both(str(p))
    assert list(d['df']['grp']) == ['lo', 'hi', 'lo', None]
    np.testing.assert_array_equal(d['df']['flag'], [1, 0, 1, 1])
    assert d['mat']['dimnames'][0] == ['r1', 'r2']


def test_load_rda_rejects_other_streams(tmp_path):
    for raw in (b'RDA3\nA\n', b'RDX3\nA\n' + u32(3) * 3):
        p = tmp_path / 'bad.rda'
        p.write_bytes(raw)
        for pkg in (trd, jrd):
            with pytest.raises(ValueError):
                pkg.load_rda(str(p))
