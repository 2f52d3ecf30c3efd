"""The benchmark's PNG reader and writer, against the program's writer."""

import numpy as np
import pytest

from bench_gpu import pngio


def test_round_trip_and_the_programs_strips(tmp_path):
    from svbrdf_tpu_torch.data import png

    image = np.random.default_rng(3).integers(0, 256, (7, 5, 3), np.uint8)
    assert (pngio.decode(pngio.encode(image)) == image).all()
    png.write_png_rgb8(str(tmp_path / "p.png"), image)
    assert (pngio.decode((tmp_path / "p.png").read_bytes()) == image).all()
    pngio.write(tmp_path / "b.png", image)
    assert (png.read_png_rgb8(str(tmp_path / "b.png")) == image).all()


def test_a_filtered_row_is_refused():
    import struct
    import zlib

    raw = bytes([1, 0, 0, 0])  # one pixel, filter type 1 (Sub)
    chunk = lambda k, p: (struct.pack(">I", len(p)) + k + p  # noqa: E731
                          + struct.pack(">I", zlib.crc32(k + p)))
    data = (pngio.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with pytest.raises(ValueError):
        pngio.decode(data)
