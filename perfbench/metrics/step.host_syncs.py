"""Host synchronisations (cudaStreamSynchronize, cudaEventSynchronize,
cudaDeviceSynchronize) inside ``BilevelEngine.step``'s span per adapted
frame, from the traced segment."""

def read(r, cfg):
    t = r.get("trace")
    if not t or not t["step_calls"]:
        return None
    return t["host_syncs"] / t["step_calls"]
