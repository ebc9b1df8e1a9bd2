"""The port's image decoders and writers (eags_slam_torch/utils/image_io.py)
against Pillow, exact: PNG files Pillow writes (gray, RGB, RGBA, 16-bit
gray; Pillow picks its own filters) and files the port writes with each
filter type and with a seeded mix of them a row; 16-bit round trips; float
TIFF against Pillow's `mode="F"` file, and the port's TIFF (either byte
order, one strip or several) read back by Pillow; palette and interlaced
PNGs and compressed TIFFs raise naming the file; the JPEG read equals
Pillow's array; the evaluator's save_render files keep their bytes."""
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from eags_slam_torch.utils import image_io as io_

SHAPES = {"gray": ((37, 53), np.uint8), "rgb": ((37, 53, 3), np.uint8),
          "rgba": ((37, 53, 4), np.uint8), "gray16": ((37, 53), np.uint16)}


def _content(kind, seed=0):
    """Seeded content with smooth parts (where the predictors matter) and
    noise (where the modular sums wrap)."""
    shape, dt = SHAPES[kind]
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dt).max
    v, u = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = (0.5 + 0.45 * np.sin(u / 6.0) * np.cos(v / 5.0)) * hi
    if len(shape) == 3:
        smooth = smooth[..., None] * np.linspace(0.4, 1.0, shape[2])
    noise = rng.integers(0, hi + 1, shape)
    img = np.where(rng.random(shape) < 0.3, noise, smooth)
    return img.astype(dt)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_png_read_matches_pillow(tmp_path, kind):
    img = _content(kind)
    path = tmp_path / "pil.png"
    Image.fromarray(img).save(path)
    got = io_.read_png(path)
    ref = np.asarray(Image.open(path))
    assert got.dtype == ref.dtype == img.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"],
                         ids=lambda f: f if isinstance(f, str)
                         else io_.FILTERS[f])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_png_filters_round_trip(tmp_path, kind, filters):
    img = _content(kind, seed=1)
    if filters == "mixed":
        filters = np.random.default_rng(2).integers(0, 5, img.shape[0])
    path = tmp_path / "port.png"
    io_.write_png(path, img, filters)
    raw = zlib.decompress(_idat(path))
    row = len(raw) // img.shape[0]
    np.testing.assert_array_equal(
        np.frombuffer(raw, np.uint8)[::row],
        np.broadcast_to(np.asarray(filters, np.uint8), (img.shape[0],)))
    np.testing.assert_array_equal(io_.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def _idat(path):
    data = open(path, "rb").read()
    pos, out = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            out += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


def test_png_16bit_depth_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.0, 13.0, (48, 64)).astype(np.float32)
    d16 = np.clip(depth * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    path = tmp_path / "d.png"
    io_.write_png(path, d16, 4)
    got = io_.read_png(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, d16)
    np.testing.assert_allclose(got / 5000.0, depth, atol=1.0 / 5000.0)


def test_png_edge_shapes(tmp_path):
    """One row, one column and a single pixel, each filter mix."""
    rng = np.random.default_rng(4)
    for shape in ((1, 9, 3), (9, 1, 3), (1, 1, 3), (1, 9), (9, 1)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for f in (3, 4, rng.integers(0, 5, shape[0])):
            io_.write_png(tmp_path / "e.png", img, f)
            np.testing.assert_array_equal(io_.read_png(tmp_path / "e.png"),
                                          img)


def test_png_unsupported_raise(tmp_path):
    img = _content("rgb")
    pal = tmp_path / "palette.png"
    Image.fromarray(img).convert("P").save(pal)
    with pytest.raises(ValueError, match="palette.png.*palette"):
        io_.read_png(pal)
    # Pillow writes no interlaced PNG: set the IHDR's interlace byte (and
    # its CRC) of a port-written file; the reader refuses before decoding.
    inter = tmp_path / "interlaced.png"
    io_.write_png(inter, img)
    data = bytearray(inter.read_bytes())
    data[28] = 1                              # IHDR: 8 + 8 + 12 bytes in
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    inter.write_bytes(bytes(data))
    assert Image.open(inter).info.get("interlace") == 1
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        io_.read_png(inter)
    la = tmp_path / "gray_alpha.png"
    Image.fromarray(img).convert("LA").save(la)
    with pytest.raises(ValueError, match="gray_alpha.png.*colour type 4"):
        io_.read_png(la)
    with pytest.raises(ValueError, match="rgb16"):
        io_.write_png(tmp_path / "rgb16.png", img.astype(np.uint16))


def test_tiff_matches_pillow(tmp_path):
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.0, 6.0, (37, 53)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = 0.0
    path = tmp_path / "pil.TIFF"
    Image.fromarray(depth, mode="F").save(path)
    got = io_.read_tiff(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, depth)
    for order in "<>":
        for rps in (None, 5):
            io_.write_tiff(tmp_path / "port.tiff", depth, order, rps)
            np.testing.assert_array_equal(
                io_.read_tiff(tmp_path / "port.tiff"), depth)
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "port.tiff")), depth)


def test_tiff_unsupported_raise(tmp_path):
    depth = np.ones((8, 8), np.float32)
    comp = tmp_path / "packed.tiff"
    Image.fromarray(depth, mode="F").save(comp, compression="tiff_adobe_deflate")
    with pytest.raises(ValueError, match="packed.tiff.*compression"):
        io_.read_tiff(comp)
    u8 = tmp_path / "bytes.tiff"
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(u8)
    with pytest.raises(ValueError, match="bytes.tiff"):
        io_.read_tiff(u8)


def test_jpeg_read_matches_pillow(tmp_path):
    img = _content("rgb", seed=6)
    path = tmp_path / "frame.jpg"
    Image.fromarray(img).save(path, quality=95)
    got = io_.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(io_.read_image(path), got)


def _old_write_png(path, rgb):
    """The evaluator's writer before it moved to utils/image_io.py."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def test_save_render_bytes_unchanged(tmp_path):
    """The evaluator's `save_render` files are byte for byte what the
    writer it had before produced."""
    from eags_slam_torch.evaluation import evaluator

    img = _content("rgb", seed=7)
    evaluator.write_png(os.path.join(tmp_path, "new.png"), img)
    _old_write_png(os.path.join(tmp_path, "old.png"), img)
    assert (tmp_path / "new.png").read_bytes() == \
        (tmp_path / "old.png").read_bytes()
