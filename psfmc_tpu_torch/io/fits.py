"""Self-contained FITS reader/writer (images + binary tables).

The reference delegates all FITS IO to astropy (``astropy.io.fits`` for
images, ``astropy.table.Table`` for the trace database — reference
utils.py:54-133, database.py:6-56).  astropy is not part of this
framework's dependency set, so we implement the subset of FITS needed by
the pipeline natively:

* primary image HDUs, BITPIX in {8, 16, 32, 64, -32, -64}, BSCALE/BZERO,
* arbitrary extension HDUs, transparent ``.gz`` input,
* BINTABLE extensions with TFORM codes L/B/I/J/K/E/D/A and vector repeat
  counts (used for multi-dimensional stochastics like ``xy``),
* full header round-trip: ordered cards, comments, strings with embedded
  quotes, COMMENT/HISTORY/blank cards.

Everything is host-side numpy; FITS files in this workload are <1 MB, so
a native-code codec would buy nothing (the reference likewise has no
native component — SURVEY.md section 2).
"""
from __future__ import annotations

import gzip
import io as _io
import os
import re

import numpy as np

__all__ = [
    "Header",
    "getdata",
    "getheader",
    "writeto",
    "read_hdus",
    "write_hdus",
    "read_bintable",
    "make_bintable_hdu",
]

BLOCK = 2880
CARDLEN = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE_BITPIX = {
    np.dtype(np.uint8): 8,
    np.dtype(np.int16): 16,
    np.dtype(np.int32): 32,
    np.dtype(np.int64): 64,
    np.dtype(np.float32): -32,
    np.dtype(np.float64): -64,
}

# TFORM letter -> (numpy dtype, bytes per element)
_TFORM_DTYPE = {
    "L": (np.dtype("u1"), 1),
    "B": (np.dtype("u1"), 1),
    "I": (np.dtype(">i2"), 2),
    "J": (np.dtype(">i4"), 4),
    "K": (np.dtype(">i8"), 8),
    "E": (np.dtype(">f4"), 4),
    "D": (np.dtype(">f8"), 8),
    "A": (np.dtype("S1"), 1),
}


class Header:
    """Ordered FITS header: list of (key, value, comment) cards.

    Emulates the small slice of ``astropy.io.fits.Header`` the pipeline
    uses: mapping access by key, ``set``, ``update``, ``extend``, and
    repeated blank/COMMENT cards.
    """

    def __init__(self, cards=None):
        self._cards = []  # list of [key, value, comment]
        if cards:
            for c in cards:
                self.append(c)

    # -- construction ------------------------------------------------
    def append(self, card):
        if isinstance(card, Header):
            self._cards.extend([list(c) for c in card._cards])
            return
        if isinstance(card, (tuple, list)):
            key = card[0] if len(card) > 0 else ""
            value = card[1] if len(card) > 1 else ""
            comment = card[2] if len(card) > 2 else ""
        else:
            key, value, comment = card, "", ""
        self._cards.append([str(key).upper() if key else "", value, comment])

    def extend(self, cards):
        for c in cards:
            self.append(c)

    # -- mapping interface -------------------------------------------
    def _find(self, key):
        key = key.upper()
        for i, c in enumerate(self._cards):
            if c[0] == key:
                return i
        return -1

    def __contains__(self, key):
        return self._find(key) >= 0

    def __getitem__(self, key):
        i = self._find(key)
        if i < 0:
            raise KeyError(key)
        return self._cards[i][1]

    def get(self, key, default=None):
        i = self._find(key)
        return self._cards[i][1] if i >= 0 else default

    def __setitem__(self, key, value):
        if isinstance(value, tuple):
            value, comment = value
        else:
            comment = None
        self.set(key, value, comment)

    def set(self, key, value=None, comment=None):
        i = self._find(key)
        if i >= 0:
            self._cards[i][1] = value
            if comment is not None:
                self._cards[i][2] = comment
        else:
            self._cards.append([key.upper(), value, comment or ""])

    def update(self, other):
        if isinstance(other, Header):
            items = [(c[0], (c[1], c[2])) for c in other._cards]
        elif hasattr(other, "items"):
            items = list(other.items())
        else:
            items = list(other)
        for key, value in items:
            if isinstance(value, tuple):
                self.set(key, value[0], value[1] if len(value) > 1 else None)
            else:
                self.set(key, value)

    def keys(self):
        return [c[0] for c in self._cards]

    def items(self):
        return [(c[0], c[1]) for c in self._cards]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._cards)

    def copy(self):
        return Header([tuple(c) for c in self._cards])

    def cards(self):
        return [tuple(c) for c in self._cards]

    def __repr__(self):
        return "\n".join(_format_card(k, v, c) for k, v, c in self._cards)


# ---------------------------------------------------------------------------
# Card-level parse / format
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([EDed][+-]?\d+)?$")


def _parse_value(raw):
    """Parse the value field of a header card."""
    raw = raw.strip()
    if raw == "":
        return ""
    if raw.startswith("'"):
        # find closing quote, honoring doubled quotes
        out = []
        i = 1
        while i < len(raw):
            if raw[i] == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(raw[i])
            i += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    if _NUM_RE.match(raw):
        sval = raw.replace("D", "E").replace("d", "e")
        if re.match(r"^[+-]?\d+$", raw):
            return int(raw)
        return float(sval)
    return raw


def _parse_card(card):
    """Return (key, value, comment) or None for END."""
    key = card[:8].rstrip()
    if key == "END":
        return None
    if key in ("COMMENT", "HISTORY", ""):
        return (key, card[8:].rstrip(), "")
    if card[8:10] != "= ":
        return (key, card[8:].rstrip(), "")
    body = card[10:]
    # split off the comment: '/' outside a string
    in_str = False
    comment = ""
    value_part = body
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "'":
            if in_str and i + 1 < len(body) and body[i + 1] == "'":
                i += 2
                continue
            in_str = not in_str
        elif ch == "/" and not in_str:
            value_part = body[:i]
            comment = body[i + 1 :].strip()
            break
        i += 1
    return (key, _parse_value(value_part), comment)


def _format_value(value):
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return ("T" if value else "F").rjust(20)
    if isinstance(value, (int, np.integer)):
        return str(int(value)).rjust(20)
    if isinstance(value, (float, np.floating)):
        s = repr(float(value))
        if "e" in s or "E" in s:
            s = f"{float(value):.10E}"
        if len(s) > 20:
            s = f"{float(value):.13G}"
        return s.rjust(20)
    # string
    s = str(value).replace("'", "''")
    return "'" + s.ljust(8) + "'"


def _format_card(key, value, comment=""):
    key = (key or "")[:8]
    if key in ("COMMENT", "HISTORY", ""):
        card = key.ljust(8) + str(value)[: CARDLEN - 8]
        return card.ljust(CARDLEN)[:CARDLEN]
    body = key.ljust(8) + "= " + _format_value(value)
    if comment:
        body += " / " + str(comment)
    return body.ljust(CARDLEN)[:CARDLEN]


# ---------------------------------------------------------------------------
# HDU-level read / write
# ---------------------------------------------------------------------------


def _open_binary(path_or_obj):
    if hasattr(path_or_obj, "read"):
        return path_or_obj, False
    path = os.fspath(path_or_obj)
    if path.endswith(".gz"):
        return gzip.open(path, "rb"), True
    return open(path, "rb"), True


def _read_header(fobj):
    cards = []
    while True:
        block = fobj.read(BLOCK)
        if len(block) < BLOCK:
            if not cards and not block:
                return None
            raise IOError("Truncated FITS header")
        text = block.decode("ascii", "replace")
        done = False
        for i in range(0, BLOCK, CARDLEN):
            card = text[i : i + CARDLEN]
            parsed = _parse_card(card)
            if parsed is None:
                done = True
                break
            cards.append(parsed)
        if done:
            break
    return Header(cards)


def _data_nbytes(header):
    bitpix = int(header["BITPIX"])
    naxis = int(header["NAXIS"])
    if naxis == 0:
        return 0, ()
    shape = tuple(
        int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)
    )  # FITS order reversed -> C order
    n = abs(bitpix) // 8
    for s in shape:
        n *= s
    # binary tables may carry PCOUNT heap bytes
    n += int(header.get("PCOUNT", 0))
    return n, shape


def _read_data(fobj, header):
    nbytes, shape = _data_nbytes(header)
    if nbytes == 0:
        return None
    padded = ((nbytes + BLOCK - 1) // BLOCK) * BLOCK
    buf = fobj.read(padded)
    if len(buf) < nbytes:
        raise IOError("Truncated FITS data")
    raw = buf[:nbytes]
    xtension = str(header.get("XTENSION", "")).strip()
    if xtension in ("BINTABLE", "TABLE"):
        return raw  # decoded lazily by read_bintable
    dtype = _BITPIX_DTYPE[int(header["BITPIX"])]
    data = np.frombuffer(raw, dtype=dtype).reshape(shape)
    bscale = header.get("BSCALE", 1)
    bzero = header.get("BZERO", 0)
    data = data.astype(dtype.newbyteorder("="))
    if bscale != 1 or bzero != 0:
        data = data * bscale + bzero
    return data


def read_hdus(path):
    """Read all HDUs: list of (Header, data) tuples.

    Image HDUs yield numpy arrays (native byte order, BSCALE applied);
    BINTABLE HDUs yield raw record bytes (decode with ``read_bintable``).
    """
    fobj, should_close = _open_binary(path)
    try:
        hdus = []
        while True:
            header = _read_header(fobj)
            if header is None:
                break
            data = _read_data(fobj, header)
            hdus.append((header, data))
        if not hdus:
            raise IOError(f"Empty FITS file: {path}")
        return hdus
    finally:
        if should_close:
            fobj.close()


def getheader(path, ext=0):
    return read_hdus(path)[ext][0]


def getdata(path, ext=None, **_ignored):
    """Data of the first HDU with data (astropy-like convenience)."""
    hdus = read_hdus(path)
    if ext is not None:
        return hdus[ext][1]
    for header, data in hdus:
        if data is not None:
            return data
    return None


def _write_header(fobj, header, primary, data, xtension=None):
    cards = []
    if xtension:
        cards.append(("XTENSION", xtension, "binary table extension"))
    elif primary:
        cards.append(("SIMPLE", True, "conforms to FITS standard"))

    if xtension == "BINTABLE":
        # caller supplies all structural cards (BITPIX/NAXIS*/TFIELDS/...)
        for key, value, comment in header.cards():
            if key in ("SIMPLE", "XTENSION", "END"):
                continue
            cards.append((key, value, comment))
        text = "".join(_format_card(*c) for c in cards) + "END".ljust(CARDLEN)
        pad = (-len(text)) % BLOCK
        fobj.write((text + " " * pad).encode("ascii"))
        return
    else:
        if data is None:
            cards.append(("BITPIX", 8, "array data type"))
            cards.append(("NAXIS", 0, "number of array dimensions"))
        else:
            bitpix = _DTYPE_BITPIX[data.dtype]
            cards.append(("BITPIX", bitpix, "array data type"))
            cards.append(("NAXIS", data.ndim, "number of array dimensions"))
            for i, s in enumerate(reversed(data.shape)):
                cards.append((f"NAXIS{i + 1}", int(s), ""))
        if not primary:
            cards.append(("PCOUNT", 0, ""))
            cards.append(("GCOUNT", 1, ""))

    structural = {c[0] for c in cards}
    structural |= {"SIMPLE", "BITPIX", "NAXIS", "XTENSION", "END"}
    structural |= {f"NAXIS{i}" for i in range(1, 10)}
    if header is not None:
        for key, value, comment in header.cards():
            if key in structural and key not in ("COMMENT", "HISTORY", ""):
                continue
            cards.append((key, value, comment))

    text = "".join(_format_card(*c) for c in cards) + "END".ljust(CARDLEN)
    pad = (-len(text)) % BLOCK
    fobj.write((text + " " * pad).encode("ascii"))


def _pad_block(fobj, nbytes):
    pad = (-nbytes) % BLOCK
    if pad:
        fobj.write(b"\x00" * pad)


def _write_hdus_to(fobj, hdus):
    for i, (header, data) in enumerate(hdus):
        primary = i == 0
        if isinstance(data, (bytes, bytearray)):
            _write_header(fobj, header, primary, None, xtension="BINTABLE")
            fobj.write(data)
            _pad_block(fobj, len(data))
        elif data is None:
            _write_header(fobj, header, primary, None)
        else:
            data = np.ascontiguousarray(data)
            if data.dtype not in _DTYPE_BITPIX:
                data = data.astype(np.float64)
            _write_header(fobj, header, primary, data)
            raw = data.astype(data.dtype.newbyteorder(">")).tobytes()
            fobj.write(raw)
            _pad_block(fobj, len(raw))


def write_hdus(path, hdus):
    """Write HDUs to ``path`` ATOMICALLY.  Each HDU is (header, data)
    where data is a numpy array (image), raw bytes tagged by an
    XTENSION=BINTABLE header, or None.

    Atomicity matters operationally: the fitting driver overwrites the
    trace database (the ONLY copy, carrying the resume checkpoint) at
    every segment boundary — a preemption landing inside an in-place
    write would truncate it and lose the whole run.  The bytes go to a
    same-directory temp file, are fsynced, then ``os.replace``d over
    the target (atomic on POSIX); a failed write leaves the previous
    file untouched.
    """
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fobj:
            _write_hdus_to(fobj, hdus)
            fobj.flush()
            os.fsync(fobj.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def writeto(path, data, header=None, overwrite=True, **_ignored):
    """astropy-like single-image write."""
    if not overwrite and os.path.exists(path):
        raise IOError(f"File exists: {path}")
    write_hdus(path, [(header, np.asarray(data))])


# ---------------------------------------------------------------------------
# Binary tables
# ---------------------------------------------------------------------------

_TFORM_RE = re.compile(r"^(\d*)([LBIJKEDA])")


def _parse_tform(tform):
    m = _TFORM_RE.match(tform.strip())
    if not m:
        raise ValueError(f"Unsupported TFORM: {tform!r}")
    repeat = int(m.group(1)) if m.group(1) else 1
    code = m.group(2)
    return repeat, code


def read_bintable(header, raw):
    """Decode BINTABLE bytes -> (colnames, columns dict of numpy arrays)."""
    nrows = int(header["NAXIS2"])
    rowlen = int(header["NAXIS1"])
    ncols = int(header["TFIELDS"])
    names, forms = [], []
    for i in range(1, ncols + 1):
        names.append(str(header[f"TTYPE{i}"]).strip())
        forms.append(str(header[f"TFORM{i}"]).strip())

    columns = {}
    offset = 0
    raw = raw if raw is not None else b""  # zero-row tables have no data
    buf = np.frombuffer(raw[: nrows * rowlen], dtype=np.uint8).reshape(
        nrows, rowlen
    )
    for name, tform in zip(names, forms):
        repeat, code = _parse_tform(tform)
        dtype, size = _TFORM_DTYPE[code]
        nbytes = repeat * size
        field = buf[:, offset : offset + nbytes]
        if code == "A":
            col = field.tobytes()
            col = np.array(
                [
                    col[r * nbytes : (r + 1) * nbytes].decode("ascii").rstrip()
                    for r in range(nrows)
                ]
            )
        else:
            col = np.frombuffer(field.tobytes(), dtype=dtype).reshape(
                nrows, repeat
            )
            col = col.astype(dtype.newbyteorder("="))
            if code == "L":
                col = col == ord("T")
            if repeat == 1:
                col = col[:, 0]
        columns[name] = col
        offset += nbytes
    return names, columns


def _column_tform(col):
    col = np.asarray(col)
    repeat = 1 if col.ndim == 1 else int(np.prod(col.shape[1:]))
    kind = col.dtype.kind
    if kind == "b":
        return f"{repeat}L", col
    if kind in "iu":
        if col.dtype.itemsize <= 4:
            return f"{repeat}J", col.astype(np.int32)
        return f"{repeat}K", col.astype(np.int64)
    if kind == "f":
        if col.dtype.itemsize <= 4:
            return f"{repeat}E", col.astype(np.float32)
        return f"{repeat}D", col.astype(np.float64)
    if kind in "SU":
        width = col.dtype.itemsize if kind == "S" else col.dtype.itemsize // 4
        return f"{width}A", col.astype(f"S{width}")
    raise ValueError(f"Unsupported column dtype: {col.dtype}")


def make_bintable_hdu(names, columns, meta=None, extname=None):
    """Build a BINTABLE HDU: returns (Header, raw_bytes).

    ``columns`` maps name -> 1-D or 2-D numpy array (rows first).
    ``meta`` is an ordered mapping of extra header key -> value or
    (value, comment) tuples.
    """
    ncols = len(names)
    encoded = []
    tforms = []
    for name in names:
        tform, col = _column_tform(columns[name])
        tforms.append(tform)
        encoded.append(col)
    nrows = len(encoded[0]) if encoded else 0

    parts = []
    rowlen = 0
    for col in encoded:
        # explicit width (reshape(nrows, -1) is ambiguous for 0 rows)
        width = 1 if col.ndim == 1 else int(np.prod(col.shape[1:]))
        col2d = col.reshape(nrows, width)
        if col2d.dtype.kind == "b":
            bytecol = np.where(col2d, ord("T"), ord("F")).astype(np.uint8)
        elif col2d.dtype.kind == "S":
            width = col2d.dtype.itemsize
            bytecol = np.frombuffer(
                col2d.tobytes(), dtype=np.uint8
            ).reshape(nrows, width)
        else:
            be = col2d.astype(col2d.dtype.newbyteorder(">"))
            bytecol = np.frombuffer(be.tobytes(), dtype=np.uint8).reshape(
                nrows, width * be.dtype.itemsize
            )
        parts.append(bytecol)
        rowlen += bytecol.shape[1]

    if parts:
        raw = np.concatenate(parts, axis=1).tobytes()
    else:
        raw = b""

    header = Header()
    header.set("BITPIX", 8, "array data type")
    header.set("NAXIS", 2, "number of array dimensions")
    header.set("NAXIS1", rowlen, "length of dimension 1")
    header.set("NAXIS2", nrows, "length of dimension 2")
    header.set("PCOUNT", 0, "number of group parameters")
    header.set("GCOUNT", 1, "number of groups")
    header.set("TFIELDS", ncols, "number of table fields")
    for i, (name, tform) in enumerate(zip(names, tforms), start=1):
        header.set(f"TTYPE{i}", name, "")
        header.set(f"TFORM{i}", tform, "")
    if extname:
        header.set("EXTNAME", extname, "")
    if meta:
        items = meta.items() if hasattr(meta, "items") else meta
        for key, value in items:
            if isinstance(value, tuple):
                header.set(key, value[0], value[1] if len(value) > 1 else None)
            else:
                header.set(key, value)
    return header, raw
