"""A ``torch.profiler`` trace of a short segment, reduced to what the
per-layer readers need: device busy time (the union of kernel, copy and
set intervals), the traced window, kernels by name with their durations,
host syncs inside the step's span, and idle gaps labelled by the host
operation that was running in each."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")
STEP_SPAN = "BilevelEngine.step"


def profile(body, device) -> dict:
    """Run ``body()`` under the profiler, synchronised at both ends."""
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        body()
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce(events)
    out["window_s"] = window
    return out


def reduce(events: list) -> dict:
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e)
    kernels = defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]].append(e["dur"] * 1e-6)
    if not spans:
        spans = [(0.0, 0.0)]
    busy, end, gaps = 0.0, None, []
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b

    steps = [e for e in events if e.get("name") == STEP_SPAN
             and e.get("cat") == "user_annotation"]
    main_tid = steps[0]["tid"] if steps else None
    syncs = 0
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("name") in SYNC_CALLS:
            t = e["ts"]
            syncs += any(s["tid"] == e.get("tid") and s["ts"] <= t
                         <= s["ts"] + s["dur"] for s in steps)
    ops = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation")
                  and e.get("tid") == main_tid and "dur" in e),
                 key=lambda x: (x[0], -x[1]))
    return {"busy_s": busy * 1e-6, "kernels": dict(kernels),
            "n_kernels": sum(len(v) for v in kernels.values()),
            "step_calls": len(steps), "host_syncs": syncs,
            "idle_by_host_op": label_gaps(gaps, ops)}


def label_gaps(gaps: list, ops: list) -> dict:
    """Seconds of device idle time by the innermost host operation running
    at each gap's midpoint ("(no op)" where none was)."""
    out = defaultdict(float)
    stack, i = [], 0
    for a, b in sorted(gaps):
        m = 0.5 * (a + b)
        while i < len(ops) and ops[i][0] <= m:
            stack.append(ops[i])
            i += 1
        stack = [o for o in stack if o[1] >= m]
        name = stack[-1][2] if stack else "(no op)"
        out[name] += (b - a) * 1e-6
    return dict(out)


def breakdown(tr: dict, top: int = 10) -> dict:
    ops = sorted(((k, sum(v)) for k, v in tr["kernels"].items()),
                 key=lambda x: -x[1])[:top]
    idle = sorted(tr["idle_by_host_op"].items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
