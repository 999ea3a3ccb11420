"""Frames adapted and predicted in the window over the window's seconds
(a synchronize before the first timed frame and after the last); frames
the app passes through without a person are not counted."""

def read(r, cfg):
    return r["adapted"] / r["window_s"]
