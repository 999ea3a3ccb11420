"""The protocol's FLOPs of the traced segment (each frame's HMR forwards
and backwards by its number of updates, counted from the configuration's
shapes) over the segment's device time times the H100's float32 peak
outside the tensor cores, in percent: the whole step's share of the peak
while the device works, which ``device_ms_per_frame`` moves."""

from perfbench.harness import work


def read(r, cfg):
    t = r.get("trace")
    if not t or not t.get("updates") or t["busy_s"] <= 0:
        return None
    flops = sum(work.frame_flops(cfg["model"], cfg["adapt"], n)
                for n in t["updates"])
    return 100.0 * flops / (t["busy_s"] * work.PEAK_FP32_FLOPS)
