"""The stream app's own render time per record on its emit worker
(``run``'s returned ``emit_ms["render"]``), in the window."""

def read(r, cfg):
    s = r.get("summary")
    return None if s is None else s["emit_ms"]["render"]
