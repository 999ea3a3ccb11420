"""The mean time a steady frame's record waits in the stream app, from the
end of its own ``AdaptPipeline.submit`` until the render worker takes it
up (``run``'s returned ``wait_ms["pipeline"]``), in the window."""

def read(r, cfg):
    s = r.get("summary")
    w = None if s is None else s.get("wait_ms")
    return None if w is None else w["pipeline"]
