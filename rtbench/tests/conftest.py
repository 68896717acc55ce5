"""The tiny size of the SPD scene kind and the faults of its entry
(``entries/spd_frame.py``), which ``tiny.py`` and ``faults.py`` were written
before: the SPD frame loop can have the frame loop's faults.

``test_rtbench_faults.py`` reads ``faults.OF_ENTRY`` for every cell when it
is imported, and its sharded test starts its ranks by the spawn method:
each imports that module afresh, and this file is not imported there.  So
the ranks start through ``_rank`` here, which registers first."""

import pytest

from rtbench import faults
from rtbench.tests import tiny

# size factor 3: 64 tetrahedra, 256 triangles, one a level-3 object
tiny.TINY_SCENE.setdefault("sierpinski_tetra", {"size_factor": 3})
faults.OF_ENTRY.setdefault("spd_frame", faults.OF_ENTRY["frame"])


def _rank(*args):
    """``test_rtbench_faults._rank`` in a spawned rank, after the
    registrations above (this module's import)."""
    from rtbench.tests import test_rtbench_faults

    test_rtbench_faults._rank(*args)


@pytest.fixture(autouse=True)
def _ranks_register(request, monkeypatch):
    if request.module.__name__.endswith(".test_rtbench_faults"):
        monkeypatch.setattr(request.module, "_rank", _rank)
