"""Pure-numpy 24-bit BMP codec, byte-compatible with the scanner binary.

A copy of ``sqtpu/data/bmp.py`` (the port imports nothing of the JAX
package). :func:`read_bmp` gives (H, W) uint8 grayscale; :func:`write_bmp`
writes the scanner's layout: 54-byte header, bottom-up rows, BGR
triplets, rows padded to 4 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

_FILE_HEADER = struct.Struct("<2sIHHI")
_INFO_HEADER = struct.Struct("<IiiHHIIiiII")


def read_bmp(path_or_bytes) -> np.ndarray:
    """Read an uncompressed 24-bit (or 8-bit paletted / 32-bit) BMP as
    (H, W) uint8 grayscale."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()

    magic, _size, _r1, _r2, data_offset = _FILE_HEADER.unpack_from(buf, 0)
    if magic != b"BM":
        raise ValueError("not a BMP file")
    (hdr_size, width, height, _planes, bpp, compression,
     _img_size, _xppm, _yppm, _ncolors, _nimportant) = _INFO_HEADER.unpack_from(buf, 14)
    if compression != 0:
        raise ValueError(f"unsupported BMP compression {compression}")

    bottom_up = height > 0
    height = abs(height)
    row_bytes = (width * bpp // 8 + 3) & ~3

    raw = np.frombuffer(buf, dtype=np.uint8, count=row_bytes * height,
                        offset=data_offset)
    rows = raw.reshape(height, row_bytes)

    if bpp == 24:
        img = rows[:, : width * 3].reshape(height, width, 3)[:, :, 0]
    elif bpp == 32:
        img = rows[:, : width * 4].reshape(height, width, 4)[:, :, 0]
    elif bpp == 8:
        img = rows[:, :width]
    else:
        raise ValueError(f"unsupported bpp {bpp}")

    if bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img)


def write_bmp(path, img: np.ndarray) -> None:
    """Write (H, W) uint8 grayscale as a 24-bit BMP, scanner layout."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    row_bytes = (w * 3 + 3) & ~3
    data_size = row_bytes * h
    file_size = 54 + data_size

    rows = np.zeros((h, row_bytes), dtype=np.uint8)
    rows[:, : w * 3] = np.repeat(img[::-1], 3, axis=-1).reshape(h, w * 3)

    with open(path, "wb") as f:
        f.write(_FILE_HEADER.pack(b"BM", file_size, 0, 0, 54))
        f.write(_INFO_HEADER.pack(40, w, h, 1, 24, 0, data_size, 0, 0, 0, 0))
        f.write(rows.tobytes())
