"""Image decoding in place of cv2.imdecode / cv2.imread (IMREAD_COLOR), and
the writer in place of cv2.imwrite.

Every decoder returns BGR uint8 [H, W, 3], as cv2 does, or None where cv2
returns None (bytes that are no image, a file that is missing).

Pillow decodes every format, imported where it decodes; without Pillow an
image raises an ImportError that names it.  Gray is replicated to three
channels and alpha is dropped, as cv2 does, and the EXIF orientation is
applied, as cv2's IMREAD_COLOR applies it.  Pillow's JPEG decoder is not
cv2's libjpeg build: pixels may differ by a few gray levels.

The bytes come from outside the program (an HTTP body), so a PNG is checked
before Pillow sees it: its chunks are walked and the CRC of every critical
chunk is checked (Pillow decodes an image whose IDAT CRC is wrong; cv2
refuses it), and its header is held to cv2's limits (at most 2^20 pixels a
side and 2^30 in all; cv2 raises there, this returns None), so that no data
behind such a header is inflated.  Pillow inflates a PNG's data a row at a
time and stops at the last row the header declares: a body that deflates
1000:1 costs no more memory than its image, and the data past those rows is
ignored, as libpng ignores it with a warning.
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# formats Pillow decodes, by their leading bytes (cv2 dispatches the same way)
_PILLOW_SIGNATURES = (b"\xff\xd8\xff", b"GIF87a", b"GIF89a", b"BM", b"II*\x00",
                      b"MM\x00*", b"RIFF")
# cv2's CV_IO_MAX_IMAGE_WIDTH / _HEIGHT and CV_IO_MAX_IMAGE_PIXELS
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def imdecode(buf) -> np.ndarray | None:
    """Encoded image bytes → BGR uint8 [H, W, 3], or None if undecodable."""
    data = bytes(buf)
    if data.startswith(PNG_SIGNATURE):
        try:
            _check_png(data)
        except (ValueError, struct.error):
            return None
        return _decode_pillow(data)
    if data.startswith(_PILLOW_SIGNATURES):
        return _decode_pillow(data)
    return None


def imread(path) -> np.ndarray | None:
    """cv2.imread(path): BGR uint8 [H, W, 3], or None if the file is missing
    or undecodable."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return imdecode(data)


def imwrite(path, image: np.ndarray) -> bool:
    """cv2.imwrite(path, image) of a BGR uint8 [H, W, 3] image, through
    Pillow: a .jpg / .jpeg at quality 95 (cv2's default; Pillow's encoder is
    not cv2's libjpeg build, so the bytes and the decoded pixels differ a
    little), any other extension in Pillow's default for it.  Returns True."""
    from PIL import Image
    rgb = Image.fromarray(np.ascontiguousarray(np.asarray(image, np.uint8)[:, :, ::-1]))
    if str(path).lower().endswith((".jpg", ".jpeg")):
        rgb.save(path, quality=95)
    else:
        rgb.save(path)
    return True


def image_size(path) -> tuple[int, int]:
    """(width, height) of an image file from its header alone."""
    with open(path, "rb") as f:
        head = f.read(33)
        if head.startswith(PNG_SIGNATURE):
            if head[12:16] != b"IHDR":
                raise ValueError(f"{path}: PNG without an IHDR chunk first")
            return struct.unpack(">II", head[16:24])
    from PIL import Image
    with Image.open(path) as im:
        return im.size


def _chunks(data: bytes):
    """(type, payload) of every chunk, the CRC of the critical ones checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) != n:
            raise ValueError("truncated chunk")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if kind[0] & 0x20 == 0 and zlib.crc32(kind + payload) != crc:
            raise ValueError(f"bad CRC in chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("no IEND chunk")


def _check_png(data: bytes) -> None:
    """Raise ValueError unless the PNG's chunks are whole with good CRCs, its
    first chunk is a valid IHDR within cv2's limits and it has image data."""
    chunks = _chunks(data)
    kind, payload = next(chunks)
    if kind != b"IHDR":
        raise ValueError("PNG without an IHDR chunk first")
    width, height, _, _, compression, filtering, _ = struct.unpack(">IIBBBBB", payload)
    if compression or filtering or not width or not height:
        raise ValueError("invalid IHDR")
    if width > MAX_SIDE or height > MAX_SIDE or width * height > MAX_PIXELS:
        raise ValueError(f"{width}x{height} exceeds cv2's limits")
    if not any(kind == b"IDAT" for kind, _ in chunks):
        raise ValueError("no IDAT chunk")


def _decode_pillow(data: bytes) -> np.ndarray | None:
    try:
        from PIL import Image, ImageOps, UnidentifiedImageError
    except ImportError as e:
        raise ImportError("decoding this image needs Pillow, which is not "
                          "installed") from e
    try:
        with Image.open(io.BytesIO(data)) as im:
            # cv2's IMREAD_COLOR applies the EXIF orientation
            rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    except (UnidentifiedImageError, Image.DecompressionBombError, OSError,
            ValueError, SyntaxError):
        return None
    return np.ascontiguousarray(rgb[:, :, ::-1])
