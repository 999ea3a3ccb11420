"""The streaming runner's own time per frame: the window's seconds outside
``BilevelEngine.run_chunk``, which the entry times to its end on the
device, over the frames, in ms.  Building each frame (its upload), the
outputs' copy to the host, the per-frame records, the scalar log and the
run's result files."""

def read(r, cfg):
    if "chunk_s" not in r or not r["frames"]:
        return None
    return 1000.0 * (r["window_s"] - r["chunk_s"]) / r["frames"]
