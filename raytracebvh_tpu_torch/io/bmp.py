"""Pure-numpy BMP read/write (the JAX package's ``io/bmp.py`` without
its native-library route; the bytes are the same).

Writer mirrors the reference's SaveBMP (reference: SaveBMP.cpp:3-62):
24-bit, bottom-up rows, BGR byte order, rows padded to 4 bytes.  Reader
additionally handles 8-bit paletted (the committed Obj/Balls.bmp) and
32-bit files.
"""

from __future__ import annotations

import struct

import numpy as np


def write_bmp(path: str, image: np.ndarray) -> None:
    """Write [h, w, 3|4] uint8 or float (0..1) image as a 24-bit BMP."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    rgb = img[..., :3]
    row_size = (w * 3 + 3) & ~3
    data_size = row_size * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM",
        54 + data_size,
        0,
        0,
        54,
        40,
        w,
        h,
        1,
        24,
        0,
        data_size,
        2835,
        2835,
        0,
        0,
    )
    rows = np.zeros((h, row_size), np.uint8)
    # BGR, bottom-up (reference: SaveBMP.cpp pads and flips the same way)
    rows[:, : w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows.tobytes())


def read_bmp(path: str) -> np.ndarray:
    """Read an uncompressed 8/24/32-bit BMP as [h, w, 3] uint8 (RGB)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    data_offset = struct.unpack_from("<I", buf, 10)[0]
    hdr_size = struct.unpack_from("<I", buf, 14)[0]
    w, h = struct.unpack_from("<ii", buf, 18)
    bpp = struct.unpack_from("<H", buf, 28)[0]
    compression = struct.unpack_from("<I", buf, 30)[0]
    if compression != 0:
        raise ValueError(f"{path}: compressed BMP not supported")
    flip = h > 0
    h = abs(h)
    row_size = (w * bpp // 8 + 3) & ~3
    raw = np.frombuffer(buf, np.uint8, row_size * h, data_offset)
    raw = raw.reshape(h, row_size)
    if bpp == 8:
        pal = np.frombuffer(buf, np.uint8, 4 * 256, 14 + hdr_size).reshape(256, 4)
        idx = raw[:, :w]
        img = pal[idx][..., :3][..., ::-1]  # BGRX palette -> RGB
    elif bpp == 24:
        img = raw[:, : w * 3].reshape(h, w, 3)[..., ::-1]
    elif bpp == 32:
        img = raw[:, : w * 4].reshape(h, w, 4)[..., :3][..., ::-1]
    else:
        raise ValueError(f"{path}: {bpp}-bit BMP not supported")
    if flip:
        img = img[::-1]
    return np.ascontiguousarray(img)
