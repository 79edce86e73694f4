"""Image decoding in place of cv2.imdecode / cv2.imread (IMREAD_COLOR).

Every function returns BGR uint8 [H, W, 3], as cv2 does, or None where cv2
returns None (bytes that are no image, a file that is missing).

PNG is decoded here with zlib and numpy alone, so the port reads PNG bodies
without Pillow: 8-bit gray, RGB and RGBA, not interlaced, every row filter.
Gray is replicated to three channels and alpha is dropped, as cv2 does.
None, Sub and Up rows are numpy operations on whole runs of rows; Average
and Paeth rows depend on the byte before them in the row and run a Python
loop over the row's bytes, which is correct but slow.

The bytes come from outside the program (an HTTP body), so a PNG is held to
cv2's limits on its header before anything is inflated (at most 2^20 pixels
a side and 2^30 in all; cv2 raises there, this returns None), and its data
is inflated no further than the rows the header declares: a body that
deflates 1000:1 costs no more memory than its image.  Data past those rows
is ignored, as libpng ignores it with a warning.

Every other image (JPEG, and PNG of another bit depth, colour type or
interlace) goes through Pillow, imported where it decodes; without Pillow
such an image raises an ImportError that names it.  Pillow's JPEG decoder is
not cv2's libjpeg build: pixels may differ by a few gray levels.
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
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type → channels this decoder reads
# cv2's CV_IO_MAX_IMAGE_WIDTH / _HEIGHT and CV_IO_MAX_IMAGE_PIXELS
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


class _Unsupported(Exception):
    """A valid PNG of a kind this decoder leaves to Pillow."""


def imdecode(buf) -> np.ndarray | None:
    """Encoded image bytes → BGR uint8 [H, W, 3], or None if undecodable."""
    data = bytes(buf)
    if data.startswith(PNG_SIGNATURE):
        try:
            return _decode_png(data)
        except _Unsupported:
            return _decode_pillow(data)
        except (ValueError, zlib.error, struct.error):
            return None
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


def _decode_png(data: bytes) -> np.ndarray:
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError("no IHDR or IDAT chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if compression or filtering or not width or not height:
        raise ValueError("invalid IHDR")
    if width > MAX_SIDE or height > MAX_SIDE or width * height > MAX_PIXELS:
        raise ValueError(f"{width}x{height} exceeds the decoder's limits")
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise _Unsupported
    channels = _CHANNELS[colour]
    stride = width * channels
    need = height * (stride + 1)
    raw = zlib.decompressobj().decompress(b"".join(idat), need)
    if len(raw) < need:
        raise ValueError("image data too short")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = _unfilter(rows[:, 0], rows[:, 1:], channels)
    img = out.reshape(height, width, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def _unfilter(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: rows [H, stride] of filtered bytes.

    A run of rows with one filter is undone at once where the filter allows:
    None copies, Sub is a running sum along each row of each channel, Up a
    running sum down the run from the row above it, all modulo 256 (uint8
    sums wrap).  So a whole image takes a few numpy calls, which release the
    interpreter lock, and a server decoding bodies in several threads is not
    serialised by a Python loop over rows."""
    height, stride = rows.shape
    out = np.empty_like(rows)
    prev = np.zeros(stride, np.uint8)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(kinds)) + 1, [height]])
    for y, end in zip(starts[:-1].tolist(), starts[1:].tolist()):
        kind, run = int(kinds[y]), rows[y:end]
        if kind == 0:      # None
            out[y:end] = run
        elif kind == 1:    # Sub
            out[y:end] = np.cumsum(run.reshape(end - y, -1, bpp), axis=1,
                                   dtype=np.uint8).reshape(end - y, stride)
        elif kind == 2:    # Up
            out[y:end] = np.cumsum(run, axis=0, dtype=np.uint8) + prev
        elif kind in (3, 4):
            for r in range(y, end):
                out[r] = _unfilter_row(kind, rows[r], prev, bpp)
                prev = out[r]
        else:
            raise ValueError(f"unknown row filter {kind}")
        prev = out[end - 1]
    return out


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4): each byte depends on the one bpp before it."""
    cur = row.tolist()
    up = prev.tolist()
    if kind == 3:
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    else:
        for i in range(len(cur)):
            if i >= bpp:
                a, c = cur[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return np.array(cur, np.uint8)


def _decode_pillow(data: bytes) -> np.ndarray | None:
    try:
        from PIL import Image, ImageOps, UnidentifiedImageError
    except ImportError as e:
        raise ImportError("decoding this image needs Pillow, which is not "
                          "installed (the port decodes 8-bit PNG itself)") from e
    try:
        with Image.open(io.BytesIO(data)) as im:
            # cv2's IMREAD_COLOR applies the EXIF orientation
            rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    except (UnidentifiedImageError, Image.DecompressionBombError, OSError,
            ValueError, SyntaxError):
        return None
    return np.ascontiguousarray(rgb[:, :, ::-1])
