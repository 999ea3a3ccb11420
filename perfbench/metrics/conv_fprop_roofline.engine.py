"""The forward-convolution kernel's share of the fp32 peak in the traced
segment of the cells that bound the device's time per frame: the FLOPs the
protocol's forward convolutions need, over 67 TFLOP/s, over the summed
device time of every trace kernel whose name carries ``KERNEL``, in
percent.

The FLOPs are counted from the configuration alone: the convolutions of
one HMR forward of one image row at its widths and resolution (the
harness's forward count without the regressor), times the image rows the
frame's forwards run at its ``adapt`` flags, summed over the segment's
frames by their numbers of updates.  So the count is the same whatever
implements the convolution.  Without such a kernel in the trace (a program
without it) the reading is None."""

from perfbench.harness import work

KERNEL = "dynaboa_conv_fprop"


def conv_flops_per_row(model: dict) -> int:
    """FLOPs (2 per multiply-add) of the 53 convolutions of one HMR
    forward of one image row."""
    return work.hmr_forward_flops({**model, "n_iter": 0})


def rows_per_frame(adapt: dict, n_updates: int) -> int:
    """Image rows whose forward one frame with ``n_updates`` outer updates
    runs: the initial forward; per inner step the lower gradient's rows
    (the frame and, where they are on, the history row and the exemplars),
    the teacher's row where it is on, and the lower record's forward; per
    update the upper gradient's rows, the teacher's row and the gate's
    forward."""
    sample = adapt["sample_num"]

    def rows(level):
        temporal = adapt[f"use_temporal_losses_{level}"]
        mixtrain = adapt[f"{level}_level_mixtrain"]
        return (1 + (1 if temporal and adapt["use_motion"] else 0)
                + (sample if mixtrain else 0))

    def teacher(level):
        return 1 if (adapt[f"use_temporal_losses_{level}"]
                     and adapt["use_meanteacher"]) else 0

    total = 1
    total += adapt["inner_step"] * (rows("lower") + teacher("lower")
                                    + (1 if adapt["record_lowerlevel"] else 0))
    total += n_updates * (rows("upper") + teacher("upper") + 1)
    return total


def read(r, cfg):
    t = r.get("trace")
    times = [d for name, ds in (t or {}).get("kernels", {}).items()
             if KERNEL in name for d in ds]
    if not times or not t.get("updates"):
        return None
    rows = sum(rows_per_frame(cfg["adapt"], n) for n in t["updates"])
    flops = conv_flops_per_row(cfg["model"]) * rows
    return 100.0 * flops / work.PEAK_FP32_FLOPS / sum(times)
