"""The stream app's own main-loop time in ``AdaptPipeline.submit`` per steady
frame (``run``'s returned ``main_ms["submit"]``), in the window."""

def read(r, cfg):
    s = r.get("summary")
    return None if s is None else s["main_ms"]["submit"]
