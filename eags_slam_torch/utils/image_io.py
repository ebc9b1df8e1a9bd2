"""The port's image decoders and writers (numpy and the standard library).

  - PNG read: 8-bit gray, RGB and RGBA and 16-bit gray (big-endian samples),
    non-interlaced, every filter type. Rows whose filters are all None /
    Sub / Up unfilter row by row (Sub is a cumulative sum mod 256 per
    channel); an image with an Average or Paeth row, whose predictors need
    the reconstructed left neighbour, unfilters along anti-diagonals: with
    diagonals d-1 and d-2 reconstructed, every pixel of diagonal d is
    independent, so each step computes, for the whole diagonal, the
    predictor of every filter that occurs and takes each row's.
  - PNG write: the same formats, with a filter type for every row (all None
    by default) and zlib level 6.
  - TIFF read and write: uncompressed float32, one sample per pixel, in
    strips, either byte order (what Pillow's `mode="F"` writer produces).
  - JPEG read: through Pillow, imported in the function; without Pillow it
    raises ImportError naming the file.

Every reader raises ValueError naming the file on a layout it does not
support (palette, interlace, other bit depths, compressed TIFF).
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the types read and written here.
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}
FILTERS = ("none", "sub", "up", "average", "paeth")


def _unsupported(path, what: str) -> ValueError:
    return ValueError(f"{path}: {what} is not supported")


def read_png(path) -> np.ndarray:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8, or (H, W) uint16
    for a 16-bit gray file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype == 3:
        raise _unsupported(path, "a palette PNG")
    if interlace:
        raise _unsupported(path, "an Adam7-interlaced PNG")
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or (
            depth == 16 and ctype != 0):
        raise _unsupported(path, f"PNG colour type {ctype} at bit depth "
                                 f"{depth}")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{w} x {h} x {bpp}")
    raw = raw.reshape(h, 1 + w * bpp)
    ftypes = raw[:, 0]
    if int(ftypes.max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown PNG filter type "
                         f"{int(ftypes.max())}")
    body = raw[:, 1:].reshape(h, w, bpp)
    if not ftypes.any():
        img = body
    elif int(ftypes.max()) <= 2:
        img = _unfilter_rows(body, ftypes)
    else:
        img = _unfilter_diagonals(body, ftypes)
    if depth == 16:
        return img.reshape(h, w * 2).view(">u2").astype(np.uint16)
    return img[..., 0].copy() if ch == 1 else np.ascontiguousarray(img)


def _unfilter_rows(body: np.ndarray, ftypes: np.ndarray) -> np.ndarray:
    """Rows filtered with None, Sub or Up, each vectorised over its row."""
    out = np.empty_like(body)
    prev = np.zeros_like(body[0])
    for y, ft in enumerate(ftypes.tolist()):
        row = body[y]
        if ft == 1:
            row = np.cumsum(row, axis=0, dtype=np.uint8)
        elif ft == 2:
            row = row + prev
        out[y] = row
        prev = out[y]
    return out


def _unfilter_diagonals(body: np.ndarray, ftypes: np.ndarray) -> np.ndarray:
    """Any mix of filters, one anti-diagonal at a time.

    Pixel (y, x) lies on diagonal d = y + x. Its left neighbour (y, x-1) and
    its upper one (y-1, x) lie on d-1, its upper-left (y-1, x-1) on d-2. In
    the sheared array S[d + 1, 1 + y] = pixel (y, d - y) (row 0 and slice 0
    stay zero) those are S[d, 1 + y], S[d, y] and S[d - 1, y], so each step
    reads slices of the two before it. A step writes only the rows whose
    pixel lies on the image; the others stay zero, which is what PNG takes
    past the left and top edges."""
    h, w, bpp = body.shape
    n_diag = h + w - 1
    ys = np.arange(h)[:, None]
    d_idx = ys + np.arange(w)[None, :]
    fs = np.zeros((n_diag, h, bpp), np.int16)       # filtered bytes, sheared
    fs[d_idx, ys] = body
    S = np.zeros((n_diag + 1, h + 1, bpp), np.int16)
    # One int16 0/1 column per filter that occurs (None needs none).
    masks = {k: (ftypes == k).astype(np.int16)[:, None]
             for k in range(1, 5) if (ftypes == k).any()}
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a = S[d, lo + 1:hi + 1]                      # left
        b = S[d, lo:hi]                              # up
        pred = fs[d, lo:hi].copy()
        if 1 in masks:
            pred += masks[1][lo:hi] * a
        if 2 in masks:
            pred += masks[2][lo:hi] * b
        if 3 in masks:
            pred += masks[3][lo:hi] * ((a + b) >> 1)
        if 4 in masks:
            c = S[max(d - 1, 0), lo:hi]              # upper-left
            sb, sa = b - c, a - c
            pa, pb, pc = np.abs(sb), np.abs(sa), np.abs(sa + sb)
            paeth = np.where(pb <= pc, b, c)
            np.copyto(paeth, a, where=(pa <= pb) & (pa <= pc))
            pred += masks[4][lo:hi] * paeth
        pred &= 255
        S[d + 1, lo + 1:hi + 1] = pred
    return S[1:, 1:][d_idx, ys].astype(np.uint8)


def _filter_rows(img: np.ndarray, ftypes: np.ndarray) -> np.ndarray:
    """The filtered bytes of (H, W, bpp) uint8 `img`, row y with filter
    `ftypes[y]` (predictors from the unfiltered neighbours)."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    pred = np.choose(ftypes[:, None, None].astype(np.intp), preds)
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path, img: np.ndarray,
              filters: Union[None, int, Sequence[int]] = None) -> None:
    """Write (H, W) uint8 gray, (H, W, 3) RGB, (H, W, 4) RGBA or (H, W)
    uint16 gray as a PNG file (zlib level 6). `filters`: a filter type
    (0-4, `FILTERS`) for every row, or one a row; None writes every row
    unfiltered."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
        pix = img.astype(">u2").view(np.uint8).reshape(*img.shape, 2)
    elif img.dtype == np.uint8 and (img.ndim == 2 or img.shape[-1] in (3, 4)):
        depth = 8
        ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[-1]]
        pix = img.reshape(img.shape[0], img.shape[1], -1)
    else:
        raise ValueError(f"{path}: cannot write a PNG of dtype {img.dtype} "
                         f"and shape {img.shape}")
    h, w = img.shape[:2]
    if filters is None:
        ftypes = np.zeros(h, np.uint8)
        rows = pix.reshape(h, -1)
    else:
        ftypes = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
        if int(ftypes.max()) > 4:
            raise ValueError(f"{path}: PNG filter types are 0-4")
        rows = _filter_rows(pix, ftypes).reshape(h, -1)
    raw = np.concatenate([ftypes[:, None], rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


# TIFF tags read and written here.
_T_WIDTH, _T_HEIGHT, _T_BITS, _T_COMPRESSION = 256, 257, 258, 259
_T_PHOTOMETRIC, _T_STRIP_OFFSETS, _T_SAMPLES = 262, 273, 277
_T_ROWS_PER_STRIP, _T_STRIP_BYTES, _T_PLANAR, _T_SAMPLE_FORMAT = \
    278, 279, 284, 339
_TIFF_TYPES = {1: "B", 3: "H", 4: "I"}        # BYTE, SHORT, LONG


def read_tiff(path) -> np.ndarray:
    """(H, W) float32 from an uncompressed one-sample float32 TIFF."""
    with open(path, "rb") as f:
        data = f.read()
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or struct.unpack(order + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path}: not a TIFF file")
    (ifd,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        e = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack(order + "HHI", data[e:e + 8])
        if typ not in _TIFF_TYPES:
            continue
        fmt = _TIFF_TYPES[typ]
        size = struct.calcsize(fmt) * count
        if size <= 4:
            raw = data[e + 8:e + 8 + size]
        else:
            (off,) = struct.unpack(order + "I", data[e + 8:e + 12])
            raw = data[off:off + size]
        tags[tag] = struct.unpack(order + fmt * count, raw)
    w, h = tags[_T_WIDTH][0], tags[_T_HEIGHT][0]
    layout = (tags.get(_T_COMPRESSION, (1,))[0],
              tags.get(_T_SAMPLES, (1,))[0], tags.get(_T_BITS, (1,)),
              tags.get(_T_SAMPLE_FORMAT, (1,))[0],
              tags.get(_T_PLANAR, (1,))[0])
    if layout[0] != 1:
        raise _unsupported(path, f"TIFF compression {layout[0]}")
    if layout[1:] != (1, (32,), 3, 1):
        raise _unsupported(path, "a TIFF other than one float32 sample a "
                                 "pixel (samples, bits, sample format, "
                                 f"planar = {layout[1:]})")
    strips = b"".join(data[o:o + c] for o, c in zip(
        tags[_T_STRIP_OFFSETS], tags[_T_STRIP_BYTES]))
    if len(strips) != 4 * w * h:
        raise ValueError(f"{path}: {len(strips)} bytes of strips for "
                         f"{w} x {h} float32")
    return np.frombuffer(strips, order + "f4").reshape(h, w).astype(
        np.float32)


def write_tiff(path, img: np.ndarray, byteorder: str = "<",
               rows_per_strip: Optional[int] = None) -> None:
    """(H, W) float32 as an uncompressed TIFF, `byteorder` "<" or ">", the
    image in strips of `rows_per_strip` rows (default: one strip)."""
    img = np.asarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"{path}: a float TIFF takes (H, W), not "
                         f"{img.shape}")
    h, w = img.shape
    rps = h if rows_per_strip is None else int(rows_per_strip)
    pixels = img.astype(byteorder + "f4").tobytes()
    strips = [pixels[4 * w * y:4 * w * min(y + rps, h)]
              for y in range(0, h, rps)]
    n_tags = 10
    ifd = 8
    extra = ifd + 2 + 12 * n_tags + 4            # out-of-line tag values
    offsets_at = extra
    counts_at = offsets_at + (4 * len(strips) if len(strips) > 1 else 0)
    data_at = counts_at + (4 * len(strips) if len(strips) > 1 else 0)
    offsets, pos = [], data_at
    for s in strips:
        offsets.append(pos)
        pos += len(s)

    def entry(tag, typ, values, at=None):
        fmt = _TIFF_TYPES[typ]
        if at is None:
            payload = struct.pack(byteorder + fmt * len(values), *values)
            payload += b"\x00" * (4 - len(payload))
        else:
            payload = struct.pack(byteorder + "I", at)
        return struct.pack(byteorder + "HHI", tag, typ, len(values)) + payload

    many = len(strips) > 1
    entries = [
        entry(_T_WIDTH, 4, [w]), entry(_T_HEIGHT, 4, [h]),
        entry(_T_BITS, 3, [32]), entry(_T_COMPRESSION, 3, [1]),
        entry(_T_PHOTOMETRIC, 3, [1]),
        entry(_T_STRIP_OFFSETS, 4, offsets, offsets_at if many else None),
        entry(_T_SAMPLES, 3, [1]), entry(_T_ROWS_PER_STRIP, 4, [rps]),
        entry(_T_STRIP_BYTES, 4, [len(s) for s in strips],
              counts_at if many else None),
        entry(_T_SAMPLE_FORMAT, 3, [3]),
    ]
    head = ({"<": b"II", ">": b"MM"}[byteorder]
            + struct.pack(byteorder + "HI", 42, ifd)
            + struct.pack(byteorder + "H", n_tags) + b"".join(entries)
            + struct.pack(byteorder + "I", 0))
    if many:
        head += struct.pack(byteorder + "I" * len(strips), *offsets)
        head += struct.pack(byteorder + "I" * len(strips),
                            *[len(s) for s in strips])
    with open(path, "wb") as f:
        f.write(head + b"".join(strips))


def pillow_image(path):
    """Pillow's `Image` module, imported here for a JPEG `path`; without
    Pillow, an ImportError naming the file."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: JPEG needs Pillow, which is not "
                          "installed") from e
    return Image


def read_jpeg(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB through Pillow (the port has no JPEG decoder of
    its own)."""
    Image = pillow_image(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_image(path) -> np.ndarray:
    """Dispatch on the file's extension: .png, .tif / .tiff, .jpg / .jpeg."""
    ext = str(path).rsplit(".", 1)[-1].lower()
    if ext == "png":
        return read_png(path)
    if ext in ("tif", "tiff"):
        return read_tiff(path)
    if ext in ("jpg", "jpeg"):
        return read_jpeg(path)
    raise ValueError(f"{path}: no reader for .{ext} files")
