"""A PNG reader and writer on ``zlib`` and numpy.

The JAX package decodes and encodes its images through PIL. This package
reads and writes them itself, so that it needs no imaging library: the
forms that the TUM, EuRoC and KITTI sequences and the replica use are

- colour type 0 (grey) at 8 and 16 bits (16-bit samples are big-endian
  on disk and come back as ``uint16``),
- colour type 2 (RGB) and 6 (RGBA) at 8 bits,

non-interlaced, with any of the five row filters. Anything else
(interlacing, palettes, grey with alpha, bit depths below 8, 16-bit
colour) raises ``PngError`` with the reason; nothing is guessed. The
writer uses the None, Sub and Up filters, picked per row.

A row filtered with Average or Paeth depends on the pixel to its left, so
those rows cannot be undone one row at a time with array operations. The
decoder then sweeps the image's anti-diagonals: pixel (r, c) depends only
on (r, c-1), (r-1, c) and (r-1, c-1), which lie on the two diagonals
before it, so one diagonal is one array step (H + W - 1 steps per image,
every filter type handled in each; a diagonal whose rows share one type
computes that type's predictor alone).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> (channels, bit depths read)
_FORMS = {0: (1, (8, 16)), 2: (3, (8,)), 6: (4, (8,))}
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey with alpha",
                 6: "RGBA"}
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


class PngError(ValueError):
    """A file this codec does not read, with the reason."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PngError(f"truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PngError(f"CRC mismatch in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PngError("no IEND chunk")


def _header(body: bytes):
    if len(body) != 13:
        raise PngError("IHDR is not 13 bytes")
    w, h, depth, colour, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", body)
    if colour not in _FORMS:
        raise PngError(f"colour type {colour} "
                       f"({_COLOUR_NAMES.get(colour, 'invalid')}) is not "
                       "read (grey, RGB and RGBA are)")
    channels, depths = _FORMS[colour]
    if depth not in depths:
        raise PngError(f"bit depth {depth} of colour type {colour} "
                       f"({_COLOUR_NAMES[colour]}) is not read (only "
                       f"{', '.join(map(str, depths))})")
    if comp != 0 or filt != 0:
        raise PngError(f"compression method {comp} / filter method {filt} "
                       "is not 0")
    if interlace != 0:
        raise PngError("interlaced (Adam7) images are not read")
    if w == 0 or h == 0:
        raise PngError("empty image")
    return w, h, depth, colour, channels


def _paeth(a, b, c):
    """The Paeth predictor of int16 neighbours: of a (left), b (up) and c
    (up-left), the one nearest to a + b - c, ties to a, then b."""
    bc = b - c
    ac = a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype, raw, bpp):
    """None, Sub and Up rows only: one row at a time."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        x, f = raw[r], ftype[r]
        if f == 0:
            row = x
        elif f == 1:
            row = np.cumsum(x.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        else:
            row = x + prev
        out[r] = row
        prev = row
    return out


def _unfilter_diagonal(ftype, raw, bpp):
    """Every filter type, by a sweep over the anti-diagonals of the pixel
    grid. The image is skewed so that diagonal k is column k: pixel (r, c)
    sits at S[r + 1, r + c + 2], the row and the two columns before it
    zero, so the left, upper and upper-left neighbours of diagonal k are
    columns k + 1, k + 1 and k of the rows before."""
    h, stride = raw.shape
    w = stride // bpp
    pix = raw.reshape(h, w, bpp).astype(np.int16)
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    skew_raw = np.zeros((h, h + w, bpp), np.int16)
    skew_raw[rows, rows + cols] = pix
    S = np.zeros((h + 1, h + w + 2, bpp), np.int16)
    ft = ftype.astype(np.int16)
    masks = [(ft == t)[:, None] for t in range(5)]
    # Rows of each type before row r: a diagonal whose rows are all of one
    # type takes that type's predictor alone.
    counts = [np.concatenate([[0], np.cumsum(m[:, 0])]) for m in masks]
    for k in range(h + w - 1):
        lo, hi = max(0, k - w + 1), min(h - 1, k) + 1
        a = S[lo + 1:hi + 1, k + 1]          # left
        b = S[lo:hi, k + 1]                  # up
        c = S[lo:hi, k]                      # up-left
        only = [t for t in range(5) if counts[t][hi] - counts[t][lo]]
        if only == [0]:
            pred = 0
        elif only == [1]:
            pred = a
        elif only == [2]:
            pred = b
        elif only == [3]:
            pred = (a + b) >> 1
        elif only == [4]:
            pred = _paeth(a, b, c)
        else:
            pred = (masks[1][lo:hi] * a + masks[2][lo:hi] * b
                    + masks[3][lo:hi] * ((a + b) >> 1)
                    + masks[4][lo:hi] * _paeth(a, b, c))
        S[lo + 1:hi + 1, k + 2] = (skew_raw[lo:hi, k] + pred) & 0xFF
    out = S[rows + 1, rows + cols + 2]
    return out.astype(np.uint8).reshape(h, stride)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] (grey) or [H, W, C] (RGB, RGBA) array, ``uint8``
    or (16-bit grey) ``uint16``."""
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind not in _CRITICAL and not (kind[0] & 0x20):
            raise PngError(f"unknown critical chunk {kind!r}")
    if header is None:
        raise PngError("no IHDR chunk")
    w, h, depth, colour, channels = header
    bpp = channels * depth // 8
    stride = w * bpp
    try:
        flat = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"bad image data: {e}") from None
    if len(flat) < h * (stride + 1):
        raise PngError(f"image data holds {len(flat)} bytes, "
                       f"{h * (stride + 1)} expected")
    rows = np.frombuffer(flat, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    ftype = rows[:, 0]
    if ftype.max() > 4:
        raise PngError(f"row filter type {int(ftype.max())} (0-4 exist)")
    raw = rows[:, 1:]
    if (ftype >= 3).any():
        px = _unfilter_diagonal(ftype, raw, bpp)
    else:
        px = _unfilter_rows(ftype, raw, bpp)
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(h, w)
    if channels == 1:
        return px.reshape(h, w)
    return px.reshape(h, w, channels)


def read(path: str) -> np.ndarray:
    """Read a PNG file (see ``decode``)."""
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(img: np.ndarray) -> bytes:
    """[H, W] ``uint8`` or ``uint16`` grey, or [H, W, 3|4] ``uint8`` RGB(A)
    -> PNG bytes. Each row takes the filter (None, Sub or Up) whose bytes,
    read as signed, sum to the least magnitude."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype == np.uint8:
        colour, depth, px = 0, 8, img[..., None]
    elif img.ndim == 2 and img.dtype == np.uint16:
        colour, depth = 0, 16
        px = img.astype(">u2").view(np.uint8).reshape(*img.shape, 2)
    elif img.ndim == 3 and img.shape[2] in (3, 4) and img.dtype == np.uint8:
        colour, depth, px = (2 if img.shape[2] == 3 else 6), 8, img
    else:
        raise PngError(f"cannot write a {img.dtype} array of shape "
                       f"{img.shape} (grey uint8/uint16, RGB(A) uint8)")
    h, w, bpp = px.shape
    raw = np.ascontiguousarray(px).reshape(h, w * bpp)
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    cands = np.stack([raw, raw - left, raw - up])       # None, Sub, Up
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)
    ftype = cost.argmin(0).astype(np.uint8)
    filtered = np.take_along_axis(cands, ftype[None, :, None].astype(
        np.int64), 0)[0]
    body = np.concatenate([ftype[:, None], filtered], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(body.tobytes()))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    """Write ``img`` as a PNG file (see ``encode``)."""
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
