"""Device kernels per adapted frame (per call of ``BilevelEngine.step``) in
the traced segment."""

def read(r, cfg):
    t = r.get("trace")
    if not t or not t["step_calls"]:
        return None
    return t["n_kernels"] / t["step_calls"]
