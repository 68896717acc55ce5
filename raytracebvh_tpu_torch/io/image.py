"""Texture image loading -> float32 [H, W, 4] in [0, 1].

Replaces the reference's DevIL-based Image class (reference:
Image.cpp:35-132 loads any format via ilLoadImage, converts to RGBA8, and
uploads a texture2D + SRV).  Here: our own BMP reader, PIL for everything
else, result is just a numpy array the shading kernel samples bilinearly.
"""

from __future__ import annotations

import os

import numpy as np

from .bmp import read_bmp


def load_texture(path: str) -> np.ndarray:
    """Load an image file as [H, W, 4] float32 RGBA in [0, 1]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        rgb = read_bmp(path)
        rgba = np.concatenate(
            [rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1
        )
    else:
        from PIL import Image

        with Image.open(path) as im:
            rgba = np.asarray(im.convert("RGBA"))
    return rgba.astype(np.float32) / 255.0
