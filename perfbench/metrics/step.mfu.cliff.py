"""The protocol's FLOPs of CLIFF's traced segment over the segment's device
time times the H100's float32 peak outside the tensor cores, in percent:
each frame's forward rows by its number of updates
(``work.rows_per_frame``, a backward counted as two forwards), each row
``harness/cliff.forward_flops`` (the trunk's 325 convolutions and the
regressor's three iterations at 256x192), all counted from the
configuration's shapes.  The whole step's share of the peak while the
device works, which ``device_ms_per_frame`` moves."""

from perfbench.harness import cliff, work


def read(r, cfg):
    t = r.get("trace")
    if not t or not t.get("updates") or t["busy_s"] <= 0:
        return None
    rows = sum(work.rows_per_frame(cfg["adapt"], n) for n in t["updates"])
    flops = rows * cliff.forward_flops(cfg["model"])
    return 100.0 * flops / (t["busy_s"] * work.PEAK_FP32_FLOPS)
