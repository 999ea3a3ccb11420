"""The GroupNorm kernel's share of its roofline in the traced segment of
the cells that bound the device's time per frame: the least traffic the
protocol's GroupNorm forwards need (each input element read once and each
output element written once, 8 B), over 3.35 TB/s, over the summed device
time of every trace kernel whose name carries ``KERNEL``, in percent.

The traffic is counted from the configuration alone: the GroupNorm
elements of one HMR image row at its widths and resolution, times the
image rows the frame's forwards normalise at its ``adapt`` flags, summed
over the segment's frames by their numbers of updates.  Without such a
kernel in the trace (a program without it) the reading is None."""

from perfbench.harness import work

KERNEL = "dynaboa_group_norm"
BYTES_PER_ELEMENT = 8         # float32 read once, float32 written once


def elements_per_row(model: dict) -> int:
    """Elements the GroupNorms of one HMR forward of one image row
    normalise: conv1's output, then in every bottleneck bn1 at its input's
    size, bn2 and bn3 at its output's, and the first block's downsample
    (ResNet-50 with stride on the 3x3 convolution)."""
    w, res = model["width"], model["img_res"]
    s = (res + 2 * 3 - 7) // 2 + 1          # conv1, stride 2, pad 3
    total = w * s * s
    s = (s + 2 - 3) // 2 + 1                # max pool 3, stride 2, pad 1
    for li, (mult, blocks) in enumerate(zip((1, 2, 4, 8), model["layers"])):
        planes = w * mult
        for b in range(blocks):
            stride = 2 if (b == 0 and li > 0) else 1
            s_out = (s + 2 - 3) // stride + 1
            total += planes * s * s + planes * s_out * s_out
            total += (2 if b == 0 else 1) * 4 * planes * s_out * s_out
            s = s_out
    return total


def rows_per_frame(adapt: dict, n_updates: int) -> int:
    """Image rows whose GroupNorm forward one frame with ``n_updates``
    outer updates runs: the initial forward; per inner step the lower
    gradient's rows (the frame and, where they are on, the history row and
    the exemplars), the teacher's row where it is on, and the lower
    record's forward; per update the upper gradient's rows, the teacher's
    row and the gate's forward."""
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
    nbytes = BYTES_PER_ELEMENT * elements_per_row(cfg["model"]) * rows
    return 100.0 * nbytes / work.PEAK_HBM_BYTES / sum(times)
