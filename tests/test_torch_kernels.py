"""The seam between the kernel library (``csrc/*.cu``) and ``ctypes``
(``_kernels._SIGNATURES``), on the CPU.

Every ``extern "C" int rtbvh_*`` entry that a source defines is declared
in ``_SIGNATURES``, and every declared entry is defined, with as many
arguments as the source gives it.  A stale or missing declaration fails
here, not at ``_kernels.load()`` on the card, and an argument count that
drifts from the source's fails here, not as a launch that reads its
arguments wrongly.
"""

import re

import pytest

from raytracebvh_tpu_torch import _kernels

ENTRY = re.compile(r'extern "C" int (rtbvh_\w+)\((.*?)\)\s*\{', re.S)


def _c_entries() -> dict:
    """Name -> number of parameters of every ``extern "C" int rtbvh_*``
    definition in the kernels' sources."""
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for src in _kernels.sources()
            for m in ENTRY.finditer(src.read_text())}


@pytest.mark.parametrize(
    "name", sorted(set(_c_entries()) | set(_kernels._SIGNATURES)))
def test_entry_is_defined_and_declared_alike(name):
    defined = _c_entries()
    assert name in defined, f"{name} is declared but in no source"
    assert name in _kernels._SIGNATURES, f"{name} is defined, not declared"
    assert len(_kernels._SIGNATURES[name]) == defined[name]
    assert _kernels.sources() == sorted(
        p for p in _kernels.CSRC.iterdir() if p.suffix == ".cu")
