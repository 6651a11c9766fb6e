"""The port's Radiance .hdr reader and writer (``io/hdr.py``) against the
JAX package's, on files the tests write themselves (no .hdr file is in
the repository).

* Each package reads the file the other wrote, and the floats are equal
  bit for bit; both writers write the same bytes.
* A run-length encoded file, built byte by byte here (``save_hdr``
  writes flat scanlines only): runs and literals in every channel, one
  flat scanline among the encoded ones, width 12; both readers return the
  same floats bit for bit, and they are the RGBE decoding of the pixels
  the bytes spell out.
* Any orientation other than "-Y h +X w", and a file without the
  Radiance signature, raise on both sides.
"""

import numpy as np
import pytest

from voxtracer.io import hdr as jax_hdr
from voxtracer_torch.io import hdr


def _image(seed=0, h=5, w=9):
    rng = np.random.default_rng(seed)
    img = rng.lognormal(-1.0, 2.0, (h, w, 3)).astype(np.float32)
    img[0, 0] = 0.0                          # black: exponent byte 0
    img[-1, -1] = (1e-35, 0.0, 0.0)          # below the 1e-32 threshold
    img[h // 2, w // 2] = (3.0e4, 1.0, 2.0e-3)  # a wide range in one pixel
    return img


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_each_reads_the_others_file_bit_for_bit(tmp_path):
    img = _image()
    hdr.save_hdr(tmp_path / "port.hdr", img)
    jax_hdr.save_hdr(tmp_path / "jax.hdr", img)
    for path in ("port.hdr", "jax.hdr"):
        got, want = hdr.load_hdr(tmp_path / path), jax_hdr.load_hdr(tmp_path / path)
        _same(got, want)
        assert got.shape == img.shape
        # RGBE keeps 8 mantissa bits of the brightest channel
        big = img.max(-1) > 1e-3
        np.testing.assert_allclose(got[big].max(-1), img[big].max(-1), rtol=2 ** -7)
    _same(hdr.load_hdr(tmp_path / "jax.hdr"), jax_hdr.load_hdr(tmp_path / "port.hdr"))


def test_the_writers_write_the_same_bytes(tmp_path):
    for seed, (h, w) in ((0, (5, 9)), (1, (2, 1)), (2, (16, 40))):
        img = _image(seed, h, w)
        hdr.save_hdr(tmp_path / "port.hdr", img)
        jax_hdr.save_hdr(tmp_path / "jax.hdr", img)
        port, jax_bytes = (tmp_path / "port.hdr").read_bytes(), (tmp_path / "jax.hdr").read_bytes()
        assert port == jax_bytes
        assert port.startswith(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
        assert len(port) == len(f"-Y {h} +X {w}\n") + 35 + h * w * 4


def _rle_channel(values):
    """One channel of a scanline, run-length encoded: runs of 3 or more
    equal values as (128 + n, value), the rest as (n, literals...)."""
    out, x, w = bytearray(), 0, len(values)
    while x < w:
        run = 1
        while x + run < w and values[x + run] == values[x] and run < 127:
            run += 1
        if run >= 3:
            out += bytes([128 + run, values[x]])
            x += run
            continue
        lit = 0
        while x + lit < w and lit < 128:
            nxt = values[x + lit:x + lit + 3]
            if len(nxt) == 3 and nxt[0] == nxt[1] == nxt[2]:
                break
            lit += 1
        out += bytes([lit]) + bytes(values[x:x + lit])
        x += lit
    return bytes(out)


def test_a_run_length_encoded_file_reads_the_same(tmp_path):
    h, w = 4, 12
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    px[..., 3] = rng.integers(120, 140, (h, w))
    px[0, 2:9, 0] = 200          # a run in R
    px[1, :, 3] = 130            # the whole exponent channel one run
    px[2, 5, 3] = 0              # a black pixel inside a scanline
    px[3, 0:4] = (7, 8, 9, 131)  # runs in every channel
    body = bytearray()
    for y in range(h):
        if y == 2:  # a flat scanline among the encoded ones
            body += px[y].tobytes()
            continue
        body += bytes([2, 2, w >> 8, w & 255])
        for ch in range(4):
            body += _rle_channel(px[y, :, ch].tolist())
    path = tmp_path / "rle.hdr"
    path.write_bytes(b"#?RGBE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=1.0\n\n"
                     + f"-Y {h} +X {w}\n".encode() + bytes(body))
    got, want = hdr.load_hdr(path), jax_hdr.load_hdr(path)
    _same(got, want)
    e = px[..., 3].astype(np.int32)
    expect = ((px[..., :3].astype(np.float64) + 0.5) * np.ldexp(1.0, e - 136)[..., None]
              * (e != 0)[..., None])
    np.testing.assert_array_equal(got, expect)
    assert got[2, 5].tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("res", [b"+Y 2 +X 3", b"-Y 2 -X 3", b"+X 3 -Y 2"])
def test_another_orientation_raises_on_both_sides(tmp_path, res):
    path = tmp_path / "flip.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + res + b"\n" + bytes(2 * 3 * 4))
    for load in (hdr.load_hdr, jax_hdr.load_hdr):
        with pytest.raises(ValueError, match="orientation"):
            load(path)
    path.write_bytes(b"P6\n3 2\n255\n" + bytes(18))
    for load in (hdr.load_hdr, jax_hdr.load_hdr):
        with pytest.raises(ValueError, match="Radiance"):
            load(path)
