"""The forward-convolution kernel's share of the fp32 peak in CLIFF's
traced segment: the FLOPs the protocol's forward convolutions need, over
67 TFLOP/s, over the summed device time of every trace kernel whose name
carries ``KERNEL``, in percent.

The FLOPs are counted from the configuration alone: the 325 convolutions
of one CLIFF forward of one 256x192 image row
(``harness/cliff.conv_flops``), times the image rows the frame's forwards
run at its ``adapt`` flags (``conv_fprop_roofline.engine``'s count: 4 + 5 n
a frame in 3DPW's protocol), summed over the segment's frames by their
numbers of updates.  So the count is the same whatever implements the
convolution.  Without such a kernel in the trace the reading is None."""

import os

from perfbench.harness import cliff, found, work

KERNEL = "dynaboa_conv_fprop"
_engine = found.module("metrics", "conv_fprop_roofline.engine",
                       os.path.dirname(os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__)))))


def read(r, cfg):
    t = r.get("trace")
    times = [d for name, ds in (t or {}).get("kernels", {}).items()
             if KERNEL in name for d in ds]
    if not times or not t.get("updates"):
        return None
    rows = sum(_engine.rows_per_frame(cfg["adapt"], n) for n in t["updates"])
    flops = cliff.conv_flops(cfg["model"]) * rows
    return 100.0 * flops / work.PEAK_FP32_FLOPS / sum(times)
