"""The port's PNG codec (``io/png.py``) against PIL, which serves only as
the oracle: PIL-written images decode to PIL's arrays, the port's files
decode in PIL to the written arrays, hand-built files with each row
filter (0-4) decode as PIL decodes them, and the forms the codec does not
read raise. Every comparison is exact (tolerance 0)."""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from coebslam_tpu_torch.io import png

RNG = np.random.RandomState(0)
SHAPE = (37, 53)           # odd sizes: no row or pixel count is a power of 2


def _images():
    """Noise and smooth gradients (PIL's encoder picks Sub, Up, Average
    and Paeth rows on the smooth ones) in each form PIL writes."""
    y, x = np.mgrid[0:SHAPE[0], 0:SHAPE[1]]
    smooth8 = ((3 * x + 5 * y) % 256).astype(np.uint8)
    smooth16 = (97 * x + 331 * y + RNG.randint(0, 9, SHAPE)).astype(
        np.uint16)
    rgb = np.stack([smooth8, 255 - smooth8, RNG.randint(0, 256, SHAPE)],
                   -1).astype(np.uint8)
    return {
        "L": [RNG.randint(0, 256, SHAPE).astype(np.uint8), smooth8],
        "I;16": [RNG.randint(0, 65536, SHAPE).astype(np.uint16), smooth16],
        "RGB": [RNG.randint(0, 256, SHAPE + (3,)).astype(np.uint8), rgb],
        "RGBA": [RNG.randint(0, 256, SHAPE + (4,)).astype(np.uint8),
                 np.concatenate([rgb, smooth8[..., None]], -1)],
    }


IMAGES = _images()
CASES = [(mode, i) for mode in sorted(IMAGES) for i in range(2)]


def _pil_png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _row_filters(data: bytes) -> set:
    idat = b"".join(body for kind, body in png._chunks(data)
                    if kind == b"IDAT")
    w, h = struct.unpack(">II", data[16:24])
    flat = zlib.decompress(idat)
    stride = len(flat) // h
    return set(np.frombuffer(flat, np.uint8).reshape(h, stride)[:, 0])


@pytest.mark.parametrize("mode,i", CASES)
def test_reads_what_pil_writes(mode, i):
    arr = IMAGES[mode][i]
    data = _pil_png(arr)
    got = png.decode(data)
    want = np.asarray(Image.open(io.BytesIO(data)))
    assert got.shape == want.shape == arr.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == (np.uint16 if mode == "I;16" else np.uint8)


def test_pil_writes_predictor_rows():
    """The smooth images exercise the diagonal sweep (Average / Paeth)."""
    filters = set()
    for mode in IMAGES:
        filters |= _row_filters(_pil_png(IMAGES[mode][1]))
    assert filters & {3, 4}, filters


@pytest.mark.parametrize("mode,i", CASES)
def test_pil_reads_what_the_port_writes(mode, i, tmp_path):
    arr = IMAGES[mode][i]
    path = str(tmp_path / "x.png")
    png.write(path, arr)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, arr)
    assert _row_filters(open(path, "rb").read()) <= {0, 1, 2}
    np.testing.assert_array_equal(png.read(path), arr)


def _handmade(arr, colour, depth, ftype):
    """A PNG of ``arr`` with every row filtered by ``ftype`` (the spec's
    formulas, written independently of the codec)."""
    h = arr.shape[0]
    raw = (arr.astype(">u2").view(np.uint8) if depth == 16
           else arr).reshape(h, -1).astype(np.int64)
    bpp = {0: 1, 2: 3, 6: 4}[colour] * depth // 8
    rows = []
    prev = np.zeros(raw.shape[1], np.int64)
    for r in range(h):
        x = raw[r]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        b = prev
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            out = x
        elif ftype == 1:
            out = x - a
        elif ftype == 2:
            out = x - b
        elif ftype == 3:
            out = x - (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
            out = x - pred
        rows.append(np.concatenate([[ftype], out & 0xFF]).astype(np.uint8))
        prev = x
    body = np.stack(rows).tobytes()
    ihdr = struct.pack(">IIBBBBB", arr.shape[1], h, depth, colour, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(body))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("form", ["L", "I;16", "RGB", "RGBA"])
def test_each_filter_type_decodes_as_pil(ftype, form):
    colour, depth = {"L": (0, 8), "I;16": (0, 16), "RGB": (2, 8),
                     "RGBA": (6, 8)}[form]
    arr = IMAGES[form][1]
    data = _handmade(arr, colour, depth, ftype)
    assert _row_filters(data) == {ftype}
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(want, arr)
    np.testing.assert_array_equal(png.decode(data), want)


def test_mixed_filters_per_row():
    """Rows of all five types in one image, in a seeded order."""
    arr = IMAGES["I;16"][0]
    per_row = [_handmade(arr, 0, 16, f) for f in range(5)]
    flat = [np.frombuffer(zlib.decompress(b"".join(
        body for kind, body in png._chunks(d) if kind == b"IDAT")),
        np.uint8).reshape(arr.shape[0], -1) for d in per_row]
    # Filtering a row depends on the previous row's pixels only, which are
    # the same in every variant, so rows can be mixed across them.
    choice = RNG.randint(0, 5, arr.shape[0])
    body = np.stack([flat[c][r] for r, c in enumerate(choice)]).tobytes()
    ihdr = struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], 16, 0, 0, 0,
                       0)
    data = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(body))
            + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode(data),
                                  np.asarray(Image.open(io.BytesIO(data))))


def _pil_variant(arr, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(arr) if mode is None else \
        Image.fromarray(arr).convert(mode)
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _interlaced(arr) -> bytes:
    """PIL writes no Adam7 file: set the IHDR's interlace byte (the header
    is checked before the data)."""
    data = _pil_png(arr)
    ihdr = data[16:29][:12] + b"\x01"
    return data[:8] + png._chunk(b"IHDR", ihdr) + data[33:]


@pytest.mark.parametrize("name,make,reason", [
    ("interlaced", _interlaced, "interlaced"),
    ("palette", lambda a: _pil_variant(a, "P"), "palette"),
    ("grey+alpha", lambda a: _pil_variant(a, "LA"), "grey with alpha"),
    ("1-bit", lambda a: _pil_variant(a, "1"), "bit depth 1"),
    ("not a png", lambda a: b"GIF89a" + bytes(40), "signature"),
])
def test_unsupported_forms_raise(name, make, reason):
    data = make(IMAGES["L"][1])
    with pytest.raises(png.PngError, match=reason):
        png.decode(data)


def test_corrupt_chunk_raises():
    data = bytearray(_pil_png(IMAGES["L"][0]))
    data[40] ^= 0xFF                       # inside IDAT: CRC no longer holds
    with pytest.raises(png.PngError, match="CRC"):
        png.decode(bytes(data))


def test_writer_refuses_other_arrays():
    with pytest.raises(png.PngError):
        png.encode(np.zeros((4, 4), np.float32))
    with pytest.raises(png.PngError):
        png.encode(np.zeros((4, 4, 2), np.uint8))
