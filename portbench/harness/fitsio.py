"""A small FITS reader and writer of the benchmark's own.

The benchmark writes its inputs (float32 images) and reads the program's
outputs (the trace database's ``TRACE`` binary table and the image
products) without the program's FITS codec, so that a fault in that codec
cannot hide itself.  Only what the benchmark needs: primary image HDUs
of any BITPIX and binary-table extensions with the TFORM codes L, B, I,
J, K, E and D, scalar or vector.
"""
from __future__ import annotations

import re

import numpy as np

__all__ = ["write_image", "read_image", "read_table"]

_BLOCK = 2880
_BITPIX = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}
_TFORM = {"L": ">i1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8",
          "E": ">f4", "D": ">f8"}


def _card(key, value):
    if isinstance(value, bool):
        text = f"{'T' if value else 'F':>20}"
    else:
        text = f"{value:>20}"
    return f"{key:<8}= {text}".ljust(80)


def write_image(path, data):
    """Write ``data`` (2-D) as a float32 primary HDU."""
    data = np.asarray(data, np.float32)
    cards = [_card("SIMPLE", True), _card("BITPIX", -32), _card("NAXIS", 2),
             _card("NAXIS1", data.shape[1]), _card("NAXIS2", data.shape[0]),
             "END".ljust(80)]
    header = "".join(cards).encode("ascii")
    header += b" " * (-len(header) % _BLOCK)
    body = data.astype(">f4").tobytes()
    body += b"\0" * (-len(body) % _BLOCK)
    with open(path, "wb") as fh:
        fh.write(header + body)


def _headers(raw):
    """Yield ``(header dict, data offset)`` for each HDU of a file's bytes."""
    pos = 0
    while pos < len(raw):
        head = {}
        while True:
            block = raw[pos:pos + _BLOCK].decode("ascii")
            pos += _BLOCK
            done = False
            for i in range(0, _BLOCK, 80):
                card = block[i:i + 80]
                key = card[:8].strip()
                if key == "END":
                    done = True
                    break
                if card[8:10] == "= ":
                    value = card[10:].split("/")[0].strip() if not card[10:].strip().startswith("'") \
                        else card[10:].strip().split("'")[1]
                    head[key] = value
            if done:
                break
        size = 0
        naxis = int(head.get("NAXIS", 0))
        if naxis:
            size = abs(int(head["BITPIX"])) // 8
            for i in range(1, naxis + 1):
                size *= int(head[f"NAXIS{i}"])
            size += int(head.get("PCOUNT", 0))
        yield head, pos
        pos += size + (-size % _BLOCK)


def read_image(path):
    """The primary HDU's data as a float64 array."""
    with open(path, "rb") as fh:
        raw = fh.read()
    head, pos = next(_headers(raw))
    shape = [int(head[f"NAXIS{i}"]) for i in range(int(head["NAXIS"]), 0, -1)]
    dtype = np.dtype(_BITPIX[int(head["BITPIX"])])
    data = np.frombuffer(raw, dtype, int(np.prod(shape)), pos).reshape(shape)
    data = data.astype(np.float64)
    if "BSCALE" in head or "BZERO" in head:
        data = data * float(head.get("BSCALE", 1)) + float(head.get("BZERO", 0))
    return data


def read_table(path, extname):
    """The binary table ``extname``: ``({column: array}, header dict)``;
    a vector column is ``(rows, repeat)``."""
    with open(path, "rb") as fh:
        raw = fh.read()
    for head, pos in _headers(raw):
        if head.get("XTENSION", "").strip() != "BINTABLE":
            continue
        if head.get("EXTNAME", "").strip() != extname:
            continue
        nrows, width = int(head["NAXIS2"]), int(head["NAXIS1"])
        fields = []
        for i in range(1, int(head["TFIELDS"]) + 1):
            m = re.match(r"^(\d*)([LBIJKED])", head[f"TFORM{i}"].strip())
            if m is None:
                raise ValueError(f"TFORM {head[f'TFORM{i}']!r} not read here")
            repeat = int(m.group(1) or 1)
            fields.append((head[f"TTYPE{i}"].strip(), _TFORM[m.group(2)], repeat))
        dtype = np.dtype([(n, t, (r,)) if r > 1 else (n, t) for n, t, r in fields])
        if dtype.itemsize != width:
            raise ValueError(f"row width {width} != {dtype.itemsize}")
        rows = np.frombuffer(raw, dtype, nrows, pos)
        cols = {n: np.asarray(rows[n]).astype(
                    np.float64 if np.dtype(t).kind == "f" else np.int64)
                for n, t, _ in fields}
        return cols, head
    raise KeyError(f"{path} has no binary table {extname!r}")
