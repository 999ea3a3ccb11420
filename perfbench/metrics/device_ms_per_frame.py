"""Device time a frame costs: the seconds in which a kernel, copy or set
ran on the device over the traced segment (the mix's fixed frames after
the window, the same whatever the seed), per frame, in ms.  What one card
spends on each adapted frame, whatever the host does meanwhile."""

def read(r, cfg):
    t = r.get("trace")
    if not t or not t.get("frames") or t["busy_s"] <= 0:
        return None
    return 1000.0 * t["busy_s"] / t["frames"]
