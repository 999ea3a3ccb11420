"""Seconds from process start to the first timed frame: imports, inputs,
building the system, kernel builds and the warm-up frames."""

def read(r, cfg):
    return r["setup_s"]
