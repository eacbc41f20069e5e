"""Minimal reader for R workspace files (.rda / .RData, RDX2/RDX3, XDR).

A copy of `jamie_tpu/rdata.py` (this package imports nothing of
`jamie_tpu`). The reference's scMNC pipelines ship their filtered matrices
as R data files (e.g. `motor_data_filtered.rda`); this reader decodes the
subset of R's serialization format those files use (numeric, integer,
logical and string vectors, pairlists, generic vectors (lists /
data.frames), factors and attributes) without an R installation.

Format: R internals 'serialization' spec (public). XDR = big-endian.
Only what single-cell matrices need is implemented; exotic SEXPs raise.
"""

from __future__ import annotations

import gzip
import struct
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

# SEXP type codes (R internals, Rinternals.h)
_NILSXP = 0
_SYMSXP = 1
_LISTSXP = 2
_CHARSXP = 9
_LGLSXP = 10
_INTSXP = 13
_REALSXP = 14
_CPLXSXP = 15
_STRSXP = 16
_VECSXP = 19
_RAWSXP = 24
# Serialization pseudo-types
_REFSXP = 255
_NILVALUE_SXP = 254
_GLOBALENV_SXP = 253
_UNBOUNDVALUE_SXP = 252
_MISSINGARG_SXP = 251
_BASENAMESPACE_SXP = 250
_NAMESPACESXP = 249
_PACKAGESXP = 248
_PERSISTSXP = 247
_EMPTYENV_SXP = 242
_BASEENV_SXP = 241
_ALTREP_SXP = 238

_NA_INT = -2147483648


class RObject:
    """A decoded R object: `.value` plus `.attributes` (dim, names, ...)."""

    __slots__ = ('value', 'attributes')

    def __init__(self, value: Any, attributes: Optional[Dict[str, Any]] = None):
        self.value = value
        self.attributes = attributes or {}

    def __repr__(self):
        return f'RObject({type(self.value).__name__}, attrs={list(self.attributes)})'


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.refs: List[Any] = []

    def _read(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError('truncated R data stream')
        return b

    def _int(self) -> int:
        return struct.unpack('>i', self._read(4))[0]

    def _length(self) -> int:
        n = self._int()
        if n == -1:  # long vector: upper/lower 32-bit halves
            hi, lo = struct.unpack('>II', self._read(8))
            return (hi << 32) | lo
        return n

    def header(self) -> None:
        magic = self._read(5)
        if magic not in (b'RDX2\n', b'RDX3\n'):
            raise ValueError(f'not an XDR RDA file (magic {magic!r})')
        fmt = self._read(2)
        if fmt != b'X\n':
            raise ValueError('only XDR-format R serialization is supported')
        version = self._int()
        self._int()  # writer R version
        self._int()  # minimal reader R version
        if version >= 3:
            enc_len = self._int()
            self._read(enc_len)  # native encoding name

    # ---------------------------------------------------------------- items
    def item(self) -> Any:
        flags = self._int()
        sexp = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if sexp == _NILVALUE_SXP or sexp == _NILSXP:
            return None
        if sexp == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self._int()
            return self.refs[idx - 1]
        if sexp == _SYMSXP:
            name = self.item()  # a CHARSXP
            sym = name.value if isinstance(name, RObject) else name
            self.refs.append(sym)
            return sym
        if sexp in (_GLOBALENV_SXP, _EMPTYENV_SXP, _BASEENV_SXP,
                    _UNBOUNDVALUE_SXP, _MISSINGARG_SXP, _BASENAMESPACE_SXP):
            return None
        if sexp == _LISTSXP:
            # Tagged pairlist; decode iteratively into an ordered dict.
            out: Dict[Any, Any] = {}
            i = 0
            while True:
                attrs = self.item() if has_attr else None
                tag = self.item() if has_tag else None
                car = self.item()
                if tag is None:
                    out[i] = car
                    i += 1
                else:
                    out[tag] = car
                nxt = self._int()
                nsexp = nxt & 0xFF
                if nsexp == _NILVALUE_SXP or nsexp == _NILSXP:
                    return out
                if nsexp != _LISTSXP:
                    out['__cdr__'] = self._item_with_flags(nxt)
                    return out
                has_attr = bool(nxt & 0x200)
                has_tag = bool(nxt & 0x400)
        if sexp == _CHARSXP:
            n = self._int()
            if n == -1:
                return RObject(None)
            return RObject(self._read(n).decode('utf-8', errors='replace'))
        if sexp == _ALTREP_SXP:
            return self._altrep()

        value: Any
        if sexp == _LGLSXP or sexp == _INTSXP:
            n = self._length()
            arr = np.frombuffer(self._read(4 * n), dtype='>i4').astype(np.int32)
            value = arr
        elif sexp == _REALSXP:
            n = self._length()
            value = np.frombuffer(self._read(8 * n), dtype='>f8').astype(np.float64)
        elif sexp == _CPLXSXP:
            n = self._length()
            value = np.frombuffer(self._read(16 * n), dtype='>c16').astype(np.complex128)
        elif sexp == _STRSXP:
            n = self._length()
            value = [self.item() for _ in range(n)]
            value = [v.value if isinstance(v, RObject) else v for v in value]
        elif sexp == _VECSXP:
            n = self._length()
            value = [self.item() for _ in range(n)]
        elif sexp == _RAWSXP:
            n = self._length()
            value = np.frombuffer(self._read(n), dtype=np.uint8)
        else:
            raise ValueError(f'unsupported R SEXP type {sexp}')

        attrs = self._attributes() if has_attr else {}
        return RObject(value, attrs)

    def _item_with_flags(self, flags: int) -> Any:
        # Re-dispatch an already-read flags word (rare pairlist cdr case)
        pos = self.f.tell()
        self.f.seek(pos - 4)
        return self.item()

    def _attributes(self) -> Dict[str, Any]:
        pairs = self.item()  # tagged pairlist
        if pairs is None:
            return {}
        out = {}
        for k, v in pairs.items():
            out[k if isinstance(k, str) else str(k)] = v
        return out

    def _altrep(self) -> Any:
        info = self.item()   # pairlist: class symbol, package, type
        state = self.item()
        self.item()          # attributes placeholder (fill)
        # Compact integer/real sequences: state is (n, start, step) doubles
        names = []
        if isinstance(info, dict):
            names = [k for k in info if isinstance(k, str)]
        blob = state.value if isinstance(state, RObject) else state
        if isinstance(blob, np.ndarray) and blob.size == 3:
            n, start, step = blob
            return RObject(np.arange(int(n)) * step + start)
        # Deferred strings / wrapped vectors: state holds the materialized data
        if isinstance(state, RObject):
            return state
        if isinstance(state, dict) and 0 in state:
            return state[0]
        raise ValueError(f'unsupported ALTREP object ({names})')


def _finalize(obj: Any) -> Any:
    """RObject tree -> numpy/pandas-ish Python values."""
    if isinstance(obj, RObject):
        attrs = {k: _finalize(v) for k, v in obj.attributes.items()}
        val = obj.value
        if isinstance(val, list):
            val = [_finalize(v) for v in val]
        # factor -> string array
        cls = attrs.get('class')
        if cls is not None and 'factor' in np.atleast_1d(cls).tolist():
            levels = np.asarray(attrs.get('levels', []))
            codes = np.asarray(val)
            out = np.where(codes == _NA_INT, None,
                           levels[np.maximum(codes, 1) - 1])
            return out
        # dim attribute -> reshape column-major (R layout)
        dim = attrs.get('dim')
        if dim is not None and isinstance(val, np.ndarray):
            val = val.reshape(tuple(int(d) for d in np.atleast_1d(dim)),
                              order='F')
        # data.frame / named list -> dict of columns
        names = attrs.get('names')
        if isinstance(obj.value, list) and names is not None:
            names = [n if n is not None else f'V{i}'
                     for i, n in enumerate(np.atleast_1d(names).tolist())]
            d = dict(zip(names, val))
            if cls is not None and 'data.frame' in np.atleast_1d(cls).tolist():
                d['__row_names__'] = attrs.get('row.names')
            return d
        if dim is not None and 'dimnames' in attrs:
            return {'matrix': val, 'dimnames': attrs['dimnames']}
        return val
    if isinstance(obj, dict):
        return {k: _finalize(v) for k, v in obj.items()}
    return obj


def load_rda(path: str) -> Dict[str, Any]:
    """Load an .rda/.RData file -> {variable name: value}.

    Matrices come back as numpy arrays (R column-major honored); data.frames
    as {column name: array} dicts; factors as string arrays.
    """
    with open(path, 'rb') as fh:
        head = fh.read(2)
        fh.seek(0)
        raw = fh.read()
    if head == b'\x1f\x8b':
        raw = gzip.decompress(raw)
    import io as _io
    r = _Reader(_io.BytesIO(raw))
    r.header()
    top = r.item()
    if top is None:
        return {}
    if not isinstance(top, dict):
        return {'value': _finalize(top)}
    return {str(k): _finalize(v) for k, v in top.items()
            if isinstance(k, str)}
