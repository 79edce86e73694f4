"""fdt_torch.data.image_io against cv2.imdecode / cv2.imread (IMREAD_COLOR).

Pillow decodes every format.  PNG must be bit-equal to cv2 for 8-bit gray,
BGR and BGRA images of odd widths with each of the five row filters forced
(chip_smoke.encode_png writes them), for cv2's own PNGs, whose filters vary
by row, and for palette, 16-bit and gray+alpha PNGs; the PNGs cv2 refuses
(a bad CRC, short or non-zlib data, a header over cv2's limits) give None.
JPEG is held to cv2 by its largest difference, measured here (Pillow 12.1.0
against cv2 5.0.0: 0 gray levels) and pinned.
"""
import io
import pathlib
import sys
import zlib

import cv2
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt_torch.data import image_io  # noqa: E402
from fdt_torch.data.image_io import image_size, imdecode, imread  # noqa: E402

# largest |Pillow − cv2| in gray levels on the JPEGs below (measured: 0)
JPEG_MAX_DIFF = 0
SHAPES = {"gray": (23, 37), "bgr": (19, 41, 3), "bgra": (17, 33, 4)}
FILTERS = ["none", "sub", "up", "average", "paeth"]


def _cv2(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def _image(kind: str, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, SHAPES[kind], dtype=np.uint8)


@pytest.mark.parametrize("row_filter", range(5), ids=FILTERS)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_bit_equal_to_cv2_with_each_filter_forced(kind, row_filter):
    data = chip_smoke.encode_png(_image(kind), row_filter)
    want = _cv2(data)
    got = imdecode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_with_mixed_row_filters_bit_equal_to_cv2(kind):
    """Runs of one filter next to runs of others: each run is undone at once."""
    img = _image(kind, 5)
    h = img.shape[0]
    orders = [[y % 5 for y in range(h)], ([2] * 5 + [4] * 3 + [2] * 4 + [1] * 3 + [0] * h)[:h],
              np.random.RandomState(6).randint(0, 5, h).tolist()]
    for order in orders:
        data = chip_smoke.encode_png(img, order)
        np.testing.assert_array_equal(imdecode(data), _cv2(data))


@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_written_by_cv2_bit_equal(kind):
    img = _image(kind, 1)
    img[:, : img.shape[1] // 2] //= 16  # smooth half: cv2 picks other filters
    ok, enc = cv2.imencode(".png", img)
    assert ok
    np.testing.assert_array_equal(imdecode(enc.tobytes()), cv2.imdecode(enc, cv2.IMREAD_COLOR))


def _jpeg_photo() -> np.ndarray:
    yy, xx = np.mgrid[0:120, 0:161]
    img = np.stack([(xx * 1.3) % 256, (yy * 1.7) % 256, (xx + 2 * yy) % 256], -1)
    noise = np.random.RandomState(2).randint(-12, 12, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_through_pillow_within_the_pinned_divergence(quality):
    ok, enc = cv2.imencode(".jpg", _jpeg_photo(), [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    got, want = imdecode(enc.tobytes()), cv2.imdecode(enc, cv2.IMREAD_COLOR)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= JPEG_MAX_DIFF


def test_png_kinds_left_to_pillow_equal_cv2():
    """Palette, 16-bit and gray+alpha PNGs go through Pillow."""
    from PIL import Image
    rng = np.random.RandomState(3)
    bodies = []
    for mode, shape in (("P", (20, 31, 3)), ("LA", (21, 29, 2))):
        im = Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8),
                             "LA" if mode == "LA" else "RGB")
        buf = io.BytesIO()
        (im.convert("P") if mode == "P" else im).save(buf, "PNG")
        bodies.append(buf.getvalue())
    ok, enc = cv2.imencode(".png", rng.randint(0, 65536, (9, 13, 3)).astype(np.uint16))
    bodies.append(enc.tobytes())
    for data in bodies:
        np.testing.assert_array_equal(imdecode(data), _cv2(data))


def test_without_pillow_png_and_jpeg_name_pillow(monkeypatch):
    """Pillow decodes every format: without it a PNG and a JPEG both raise an
    ImportError that names it, and bytes that are no image still give None."""
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now raises
    img = _image("bgr")
    ok, enc = cv2.imencode(".jpg", img)
    assert ok
    for data in (chip_smoke.encode_png(img), enc.tobytes()):
        with pytest.raises(ImportError, match="Pillow"):
            imdecode(data)
    assert imdecode(b"not an image") is None


def _with_bad_crc(data: bytes) -> bytes:
    i = data.index(b"IDAT")
    n = int.from_bytes(data[i - 4:i], "big")
    return data[:i + 4 + n] + bytes([data[i + 4 + n] ^ 1]) + data[i + 5 + n:]


def _png_with_idat(payload: bytes, width: int = 4, height: int = 4) -> bytes:
    """A width × height RGB PNG whose IDAT chunk carries `payload`."""
    import struct

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", payload) + chunk(b"IEND", b""))


BOMB_MB = 64  # what the bomb's IDAT inflates to; it is about 64 KB deflated


def deflate_bomb() -> bytes:
    """zlib data of BOMB_MB MB of zero bytes: rows of filter None, all black."""
    z, block = zlib.compressobj(9), bytes(1 << 20)
    return b"".join(z.compress(block) for _ in range(BOMB_MB)) + z.flush()


def _peak_mb(fn, *args):
    """(fn(*args), the peak of the memory Python and numpy allocated in MB)."""
    import tracemalloc
    tracemalloc.start()
    try:
        out = fn(*args)
        return out, tracemalloc.get_traced_memory()[1] / 2**20
    finally:
        tracemalloc.stop()


@pytest.mark.parametrize("case", ["garbage", "signature-only", "truncated", "bad-crc",
                                  "not-zlib", "short-data"])
def test_undecodable_bytes_give_none_as_cv2(case):
    png = chip_smoke.encode_png(_image("bgr"))
    data = {"garbage": b"not an image at all", "signature-only": image_io.PNG_SIGNATURE,
            "truncated": png[:60], "bad-crc": _with_bad_crc(png),
            "not-zlib": _png_with_idat(b"\x00" * 40),
            "short-data": _png_with_idat(zlib.compress(b"\x00" * 20))}[case]
    assert imdecode(data) is None
    assert _cv2(data) is None


@pytest.mark.parametrize("kind", ["png", "jpg"])
def test_imread_and_image_size_equal_cv2(tmp_path, kind):
    img = _image("bgr", 4)
    path = tmp_path / f"a.{kind}"
    if kind == "png":
        path.write_bytes(chip_smoke.encode_png(img, 4))
    else:
        cv2.imwrite(str(path), img)
    got = imread(str(path))
    np.testing.assert_array_equal(got, cv2.imread(str(path)))
    assert image_size(str(path)) == (got.shape[1], got.shape[0])
    assert imread(str(tmp_path / "missing.png")) is None


@pytest.mark.parametrize("size", [(65536, 65536), ((1 << 20) + 1, 2), (2, (1 << 20) + 1)],
                         ids=["pixels", "width", "height"])
def test_png_over_cv2s_limits_gives_none_before_inflating(size):
    """cv2 refuses such a header (it raises, or libpng refuses a side over its
    own limit of 10^6); the port returns None and never inflates the data
    behind it."""
    data = _png_with_idat(deflate_bomb(), *size)
    try:
        assert _cv2(data) is None
    except cv2.error:
        pass
    got, peak = _peak_mb(imdecode, data)
    assert got is None
    assert peak < 8, f"{peak:.1f} MB allocated for an image that was refused"


def test_png_bomb_inflates_no_further_than_its_rows():
    """A valid header of a small image on data that inflates to 64 MB:
    decoded as cv2 decodes it (the data past the rows ignored), with memory
    for the image alone."""
    w, h = 256, 128
    data = _png_with_idat(deflate_bomb(), w, h)
    got, peak = _peak_mb(imdecode, data)
    np.testing.assert_array_equal(got, _cv2(data))
    assert got.shape == (h, w, 3) and not got.any()
    assert peak < 8, f"{peak:.1f} MB allocated for a {w}x{h} image"
