"""The data-gradient kernel's share of the fp32 peak in the traced segment
of the cells that bound the device's time per frame: the FLOPs the
protocol's data gradients need, over 67 TFLOP/s, over the summed device
time of every trace kernel whose name carries ``KERNEL``, in percent.

The FLOPs are counted from the configuration alone: the data gradient of
every convolution of one HMR forward of one image row whose input is not
the image (conv1's input needs no gradient), each as many FLOPs as the
convolution itself, times the image rows the frame's gradient evaluations
backpropagate at its ``adapt`` flags (``inner_step`` lower gradients and
one upper gradient per update), summed over the segment's frames by their
numbers of updates.  So the count is the same whatever implements the
gradient.  Without such a kernel in the trace (a program without it) the
reading is None."""

from perfbench.harness import work

KERNEL = "dynaboa_conv_dgrad"


def dgrad_flops_per_row(model: dict) -> int:
    """FLOPs (2 per multiply-add) of the data gradients of one HMR forward
    of one image row: its 53 convolutions less conv1 (7x7, stride 2, pad 3,
    from the 3 image channels)."""
    w, res = model["width"], model["img_res"]
    s = (res + 2 * 3 - 7) // 2 + 1
    conv1 = 2 * 3 * w * 7 * 7 * s * s
    return work.hmr_forward_flops({**model, "n_iter": 0}) - conv1


def grad_rows_per_frame(adapt: dict, n_updates: int) -> int:
    """Image rows one frame with ``n_updates`` outer updates backpropagates:
    per inner step the lower gradient's rows (the frame and, where they are
    on, the history row and the exemplars), per update the upper
    gradient's.  The teacher's and the records' forwards take no
    gradient."""
    sample = adapt["sample_num"]

    def rows(level):
        temporal = adapt[f"use_temporal_losses_{level}"]
        mixtrain = adapt[f"{level}_level_mixtrain"]
        return (1 + (1 if temporal and adapt["use_motion"] else 0)
                + (sample if mixtrain else 0))

    return adapt["inner_step"] * rows("lower") + n_updates * rows("upper")


def share(r, cfg, flops_per_row) -> float | None:
    """The reading for a model whose data gradients take ``flops_per_row``
    a gradient row."""
    t = r.get("trace")
    times = [d for name, ds in (t or {}).get("kernels", {}).items()
             if KERNEL in name for d in ds]
    if not times or not t.get("updates"):
        return None
    rows = sum(grad_rows_per_frame(cfg["adapt"], n) for n in t["updates"])
    return 100.0 * flops_per_row * rows / work.PEAK_FP32_FLOPS / sum(times)


def read(r, cfg):
    return share(r, cfg, dgrad_flops_per_row(cfg["model"]))
