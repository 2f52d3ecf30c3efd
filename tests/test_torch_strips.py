"""The port's PNG reader and writer and its strip decoding against Pillow
and the JAX package's data/strips.py.

Tolerance: none. Every decoded byte and every decoded float must be equal.
The PNGs with each scanline filter are built here with a filter encoder of
the PNG specification's formulas, written independently of the decoder.
"""

import pathlib
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from svbrdf_tpu.data import strips as jstrips
from svbrdf_tpu_torch.data import png, strips

REPO = pathlib.Path(__file__).resolve().parents[1]
REPO_STRIPS = sorted(str(p) for p in (REPO / "data").glob("*/*.png"))


def _png_bytes(width, height, depth, colour, interlace, scanlines: bytes):
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                         colour, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(scanlines))
            + chunk(b"IEND", b""))


def _filter_rows(image: np.ndarray, filters) -> bytes:
    """Encode uint8 (H, W, bpp) with filter filters[r] on row r."""
    img = image.astype(np.int32)
    height, width, bpp = img.shape
    out = []
    for r in range(height):
        x = img[r]
        left = np.concatenate([np.zeros((1, bpp), np.int32), x[:-1]])
        up = img[r - 1] if r > 0 else np.zeros_like(x)
        up_left = np.concatenate([np.zeros((1, bpp), np.int32), up[:-1]])
        f = filters[r]
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                          np.abs(p - up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _write(tmp_path, name, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("path", REPO_STRIPS,
                         ids=[pathlib.Path(p).name for p in REPO_STRIPS])
def test_reader_equals_pil_on_the_repo_strips(path):
    mine = strips.read_image_u8(path)
    assert mine.shape == (256, 3584, 3) and mine.dtype == np.uint8
    np.testing.assert_array_equal(
        mine, np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(mine, jstrips.read_image_u8(path))


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("channels", [3, 4])
def test_every_filter_decodes_exactly(tmp_path, filters, channels):
    rng = np.random.default_rng(int(filters == "mixed") + channels)
    height, width = 13, 37
    image = rng.integers(0, 256, (height, width, channels), dtype=np.uint8)
    # Smooth regions too, so the predictors' branches all occur.
    image[5:9] = image[5:6]
    rows = (rng.integers(0, 5, height) if filters == "mixed"
            else [int(filters)] * height)
    path = _write(tmp_path, "f.png", _png_bytes(
        width, height, 8, 2 if channels == 3 else 6, 0,
        _filter_rows(image, rows)))
    np.testing.assert_array_equal(png.read_png_rgb8(path), image[..., :3])
    np.testing.assert_array_equal(png.read_png_rgb8(path),
                                  np.asarray(Image.open(path).convert("RGB")))


def test_writer_is_read_back_by_pil(tmp_path):
    image = np.random.default_rng(0).integers(0, 256, (19, 23, 3),
                                              dtype=np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png_rgb8(path, image)
    read = Image.open(path)
    assert read.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(read), image)
    np.testing.assert_array_equal(png.read_png_rgb8(path), image)


def test_write_image_equals_the_jax_writer(tmp_path):
    image = np.random.default_rng(1).uniform(-0.2, 1.2, (9, 14, 3))
    strips.write_image(str(tmp_path / "port.png"), image)
    jstrips.write_image(str(tmp_path / "jax.png"), image)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port.png")),
        np.asarray(Image.open(tmp_path / "jax.png")))


def test_rgba_is_truncated_to_rgb(tmp_path):
    """As the JAX package's Pillow path reads RGBA (its optional libpng
    loader in native/ does not drop the alpha channel alike, so it is not
    the reference here)."""
    image = np.random.default_rng(2).integers(0, 256, (8, 6, 4),
                                              dtype=np.uint8)
    path = str(tmp_path / "rgba.png")
    Image.fromarray(image, "RGBA").save(path)
    np.testing.assert_array_equal(strips.read_image_u8(path), image[..., :3])
    np.testing.assert_array_equal(strips.read_image_u8(path),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("kind", ["16bit", "palette", "grey", "interlaced",
                                  "not_png"])
def test_unsupported_images_raise_naming_the_file(tmp_path, kind):
    if kind == "not_png":
        path = _write(tmp_path, "x.jpg", b"\xff\xd8\xff\xe0 not a png")
    else:
        depth, colour, interlace = {"16bit": (16, 2, 0), "palette": (8, 3, 0),
                                    "grey": (8, 0, 0),
                                    "interlaced": (8, 2, 1)}[kind]
        path = _write(tmp_path, f"{kind}.png",
                      _png_bytes(4, 4, depth, colour, interlace, b"\0" * 64))
    with pytest.raises(ValueError, match=pathlib.Path(path).name):
        strips.read_image_u8(path)


def test_list_sample_files_counts_symlinks(tmp_path):
    (tmp_path / "a.png").write_bytes(b"")
    (tmp_path / "b.png").symlink_to(tmp_path / "a.png")
    (tmp_path / "sub").mkdir()
    assert strips.list_sample_files(str(tmp_path)) == \
        jstrips.list_sample_files(str(tmp_path)) == \
        [str(tmp_path / "a.png"), str(tmp_path / "b.png")]


@pytest.mark.parametrize("count,used,no_svbrdf", [
    (10, 1, False), (10, 3, False), (10, 10, False), (14, 2, True)])
def test_decoding_equals_jax(count, used, no_svbrdf):
    path = str(REPO / "data" / "train" / "toy_train_00.png")
    strip = strips.read_image(path)
    np.testing.assert_array_equal(strip, jstrips.read_image(path))
    for mine, ref in zip(strips.decode_strip(strip, count, no_svbrdf),
                         jstrips.decode_strip(strip, count, no_svbrdf)):
        np.testing.assert_array_equal(mine, ref)
    for mine, ref in zip(
            strips.decode_sample(strip, count, used, no_svbrdf),
            jstrips.decode_sample(strip, count, used, no_svbrdf)):
        np.testing.assert_array_equal(mine, ref)
    for mine, ref in zip(strips.load_sample(path, count, used, no_svbrdf),
                         jstrips.load_sample(path, count, used, no_svbrdf)):
        np.testing.assert_array_equal(mine, ref)
    if not no_svbrdf:
        u8 = strips.read_image_u8(path)
        for mine, ref in zip(strips.decode_strip_u8(u8, count),
                             jstrips.decode_strip_u8(u8, count)):
            np.testing.assert_array_equal(mine, ref)
