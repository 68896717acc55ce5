"""Peaks of the card, and the bytes the shading's gathers need.

The bytes follow from the inputs and the configuration alone, never from
the program's layout: a later change to how the program gathers leaves
them as they are.  A ray that hits needs, in each pass that shades it, its
face's id and its texel quad's id read (4 bytes each), and the values the
shading reads written once in float32: the three corners' positions,
normals and uvs (24 values), the material's ambient, diffuse and specular
(12), its shininess and texture id (2), and with refraction its optical
density and alpha (2 more); and the four texels of its bilinear sample (16
values).  Each face that a pass hits has those 38 (40) values read once,
and the texture table is read once a pass, in its stored width.  A ray
that misses needs nothing.  Reading a face's row once for every ray that
hits it would count a cache's hits as memory traffic.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, at its 700 W limit): HBM3 bandwidth
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}

ID_BYTES = 4
VALUE_BYTES = 4
TEXELS = 16


def face_values(refraction: bool) -> int:
    return 40 if refraction else 38


def gather_bytes(passes, texture_bytes: int, refraction: bool) -> int:
    """Bytes the gathers of a frame need: ``passes`` lists (rays hit,
    distinct faces hit) of each pass that shades; ``texture_bytes`` is the
    stored texture table's size."""
    fv = face_values(refraction)
    total = 0
    for hits, faces in passes:
        total += hits * (2 * ID_BYTES + (fv + TEXELS) * VALUE_BYTES)
        total += faces * fv * VALUE_BYTES + texture_bytes
    return total


def hbm_bytes_per_s(kind: str) -> float:
    """The card's HBM bandwidth; raises for a card without a row."""
    if kind not in PEAKS:
        raise KeyError(f"no peak for {kind!r} in rtbench/roofline.py")
    return PEAKS[kind]["hbm_bytes_per_s"]
