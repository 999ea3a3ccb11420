"""The protocol's FLOPs over the window (every frame's HMR forwards and
backwards by its number of updates, counted from the configuration's
shapes) over the window's seconds times the H100's float32 peak outside
the tensor cores, in percent."""

from perfbench.harness import work


def read(r, cfg):
    if not r.get("updates"):
        return None
    flops = sum(work.frame_flops(cfg["model"], cfg["adapt"], n)
                for n in r["updates"])
    return 100.0 * flops / (r["window_s"] * work.PEAK_FP32_FLOPS)
