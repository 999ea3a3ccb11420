"""The GroupNorm kernel's share of its roofline in CLIFF's traced segment:
the least traffic the protocol's GroupNorm forwards need (each input
element read once and each output element written once, 8 B), over 3.35
TB/s, over the summed device time of every trace kernel whose name carries
``KERNEL``, in percent.

The traffic is counted from the configuration alone: the elements the 325
GroupNorms of one CLIFF forward of one 256x192 image row normalise, each
convolution's output (``harness/cliff.norm_elements``, 27,972,864 at the
published widths), times the image rows the frame's forwards normalise at
its ``adapt`` flags (``group_norm_roofline.engine``'s count), summed over
the segment's frames by their numbers of updates.  Without such a kernel
in the trace the reading is None."""

import os

from perfbench.harness import cliff, found, work

KERNEL = "dynaboa_group_norm"
BYTES_PER_ELEMENT = 8         # float32 read once, float32 written once
_engine = found.module("metrics", "group_norm_roofline.engine",
                       os.path.dirname(os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__)))))


def read(r, cfg):
    t = r.get("trace")
    times = [d for name, ds in (t or {}).get("kernels", {}).items()
             if KERNEL in name for d in ds]
    if not times or not t.get("updates"):
        return None
    rows = sum(_engine.rows_per_frame(cfg["adapt"], n) for n in t["updates"])
    nbytes = BYTES_PER_ELEMENT * cliff.norm_elements(cfg["model"]) * rows
    return 100.0 * nbytes / work.PEAK_HBM_BYTES / sum(times)
