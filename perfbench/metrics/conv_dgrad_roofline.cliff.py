"""The data-gradient kernel's share of the fp32 peak in CLIFF's traced
segment: the FLOPs the protocol's data gradients need, over 67 TFLOP/s,
over the summed device time of every trace kernel whose name carries
``dynaboa_conv_dgrad``, in percent.

The FLOPs are counted from the configuration alone: the data gradient of
every convolution of one CLIFF forward of one 256x192 image row whose input
is not the image (the stem's first convolution's input needs no gradient),
each as many FLOPs as the convolution itself (``harness/cliff.walk``),
times the image rows the frame's gradient evaluations backpropagate
(``conv_dgrad_roofline.engine``'s count: 2 + 3 n a frame in 3DPW's
protocol), summed over the segment's frames by their numbers of updates.
Without the kernel in the trace the reading is None."""

import os

from perfbench.harness import cliff, found

_engine = found.module("metrics", "conv_dgrad_roofline.engine",
                       os.path.dirname(os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__)))))


def dgrad_flops_per_row(m: dict) -> int:
    """FLOPs (2 per multiply-add) of the data gradients of one CLIFF
    forward of one image row: its 325 convolutions less the first."""
    convs = [x for x in cliff.walk(m) if x[0] == "conv"][1:]
    return 2 * sum(cin * cout * k * k * hw[0] * hw[1]
                   for _, _, cin, cout, k, _, _, hw in convs)


def read(r, cfg):
    return _engine.share(r, cfg, dgrad_flops_per_row(cfg["model"]))
