"""``adapted_fps`` where the host's speed spreads it too widely to bound
it: frames adapted and predicted in the window over the window's
seconds."""

def read(r, cfg):
    return r["adapted"] / r["window_s"]
