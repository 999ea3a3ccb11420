"""95th percentile over every frame of the window of the time from when the
frame is handed to the app to when its composited overlay reaches the sink."""

import numpy as np


def read(r, cfg):
    lat = r.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
