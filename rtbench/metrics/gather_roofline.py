"""gather_roofline: the shading's gathers' share of their roofline, in %:
the bytes the gathers need for the traced iterations' inputs
(``roofline.gather_bytes``, from the reference's hits), over the card's
HBM bandwidth times the device time of K2 and K7 (csrc/gather.cu,
csrc/gather_cols.cu) in those iterations."""

import torch

from rtbench import roofline
from rtbench.tracing import kernel_of


def read(run):
    tr = run.traced
    passes = run.layer.get("gather_passes")
    if tr is None or passes is None:
        return None
    keep = lambda name: kernel_of(name) in ("K2", "K7")
    if not tr.count(keep):
        return None
    seconds = tr.kernel_ms(keep) * tr.iterations / 1e3
    need = sum(roofline.gather_bytes(p, run.layer["texture_bytes"],
                                     run.layer["refraction"])
               for p in passes())
    peak = roofline.hbm_bytes_per_s(torch.cuda.get_device_name(run.device))
    return 100.0 * need / (peak * seconds)
