#!/usr/bin/env python
"""Timing and device profile of the port's 3DPW main path on one CUDA card,
at full width (ResNet-50-GN, 224^2, V = 6890) with random weights and the
synthetic stream.

  python -m dynaboa_tpu_torch.apps.profile

Sections, each printed as it ends:
  1. the shipped GMM prior's NLL on the card against the CPU (its float32
     mixture weights include denormals) and log(nll_weights) on the card
  2. benchmark CLI runs of FRAMES frames with the skinning kernel on and
     off, ROUNDS pairs in the order on, off, off, on, ... so that neither
     side always runs first: steady frames/s and per-frame extra updates
  3. one CLI run with every update taken (--cos_sim_threshold -1)
  4. torch.profiler over steady frames, at the default threshold and at -1:
     device time by op and kernel, the device kernel count, and the device
     busy time and idle share over the profiled span (from the exported
     trace; busy is the union of kernel, memcpy and memset intervals)
  5. one engine with the skinning kernel switched on and off between
     blocks of frames (on, off, off, on, ...): median wall ms per frame of
     each, then one profiled frame of each, by host time per op
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FRAMES = 6
ROUNDS = 4


def gmm_section(device) -> None:
    from dynaboa_tpu_torch.losses.priors import (default_gmm_path,
                                                 gmm_prior_nll, load_gmm_prior)

    pose = torch.as_tensor(
        np.random.default_rng(0).normal(scale=0.3, size=(4, 69))
        .astype(np.float32))
    path = default_gmm_path()
    cpu = gmm_prior_nll(load_gmm_prior(path, "cpu"), pose)
    gpu_prior = load_gmm_prior(path, device)
    gpu = gmm_prior_nll(gpu_prior, pose.to(device)).cpu()
    rel = float(((gpu - cpu).abs() / cpu.abs()).max())
    print(f"GMM nll cpu {cpu.numpy()} cuda {gpu.numpy()} max rel {rel}")
    print(f"log(nll_weights) cuda "
          f"{torch.log(gpu_prior.nll_weights).cpu().numpy()}", flush=True)


def cli_run(tmp: str, name: str, device: str, frames: int, *extra) -> dict:
    from dynaboa_tpu_torch.apps import benchmark

    summary = benchmark.main([
        "--device", device, "--synthetic", str(frames), "--expdir", tmp,
        "--expname", name, *extra])
    print(f"{name}: first frame {summary['first_frame_s']:.4f} s, steady "
          f"{summary['fps']:.3f} frames/s, extra updates "
          f"{summary['optim_steps']}", flush=True)
    return summary


def device_busy(trace_path: str) -> tuple[int, float, float]:
    """(kernel count, busy us, span us) of the device events in a chrome
    trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e)
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return kernels, busy, spans[-1][1] - spans[0][0]


def profile_section(tmp: str, device: str, threshold: float, warm: int,
                    frames: int) -> None:
    from dynaboa_tpu.config import AdaptConfig, Paths
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import frame_from_item

    cfg = AdaptConfig(cos_sim_threshold=threshold, use_pallas_lbs=True)
    system = build_system(cfg, Paths(), device)
    state = system.engine.init_state(system.params, batch_size=1)
    items = list(SyntheticStream(num_frames=warm + frames, seed=22))

    def step(item):
        nonlocal state
        state, out = system.engine.step(state,
                                        frame_from_item(item, device))
        torch.cuda.synchronize()
        return int(out["optim_steps"])

    warm_steps = [step(item) for item in items[:warm]]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        steps = [step(item) for item in items[warm:]]
    label = f"thr={threshold}"
    print(f"--- profile {label}: {frames} frames after {warm} warm-up "
          f"frames; extra updates warm-up {warm_steps}, profiled {steps}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=30, max_name_column_width=60))
    trace = os.path.join(tmp, f"trace_{threshold}.json")
    prof.export_chrome_trace(trace)
    kernels, busy, span = device_busy(trace)
    print(f"{label}: {kernels} device kernels over {frames} frames; busy "
          f"{busy} us of span {span} us -> idle share {1 - busy / span:.3f}",
          flush=True)


def kernel_ab_section(tmp: str, device: str, rounds: int = 4,
                      block: int = 4) -> None:
    from dynaboa_tpu.config import AdaptConfig, Paths
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import frame_from_item

    system = build_system(AdaptConfig(use_pallas_lbs=True), Paths(), device)
    engine = system.engine
    kernel = engine._lbs_kernel      # the switch: None takes the eager lbs
    state = engine.init_state(system.params, batch_size=1)
    items = iter(SyntheticStream(num_frames=3 + 2 * rounds * block + 2,
                                 seed=22))

    def step(mode: str) -> float:
        nonlocal state
        engine._lbs_kernel = kernel if mode == "on" else None
        t0 = time.perf_counter()
        state, out = engine.step(state, frame_from_item(next(items), device))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(3):
        step("on")
    times = {"on": [], "off": []}
    for r in range(rounds):
        for mode in (("on", "off") if r % 2 == 0 else ("off", "on")):
            times[mode] += [step(mode) for _ in range(block)]
    for mode, ts in times.items():
        print(f"kernel {mode}, in process: median frame "
              f"{statistics.median(ts) * 1e3:.2f} ms over {len(ts)} frames "
              f"{[round(t * 1e3, 2) for t in ts]}", flush=True)
    for mode in ("on", "off"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(mode)
        print(f"--- kernel {mode}: one profiled frame, by host time")
        print(prof.key_averages().table(sort_by="cpu_time_total",
                                        row_limit=25,
                                        max_name_column_width=60))
        trace = os.path.join(tmp, f"trace_kernel_{mode}.json")
        prof.export_chrome_trace(trace)
        kernels, busy, span = device_busy(trace)
        print(f"kernel {mode}: {kernels} device kernels; busy {busy} us of "
              f"span {span} us", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the profile needs a CUDA device")
    device = "cuda"
    tmp = tempfile.mkdtemp(prefix="dynaboa_profile_")
    try:
        gmm_section(device)
        for r in range(ROUNDS):
            for lbs in ((1, 0) if r % 2 == 0 else (0, 1)):
                cli_run(tmp, f"kernel_{'on' if lbs else 'off'}_{r}", device,
                        FRAMES, "--use_pallas_lbs", str(lbs))
        cli_run(tmp, "kernel_on_thr-1", device, FRAMES - 2,
                "--use_pallas_lbs", "1", "--cos_sim_threshold", "-1")
        profile_section(tmp, device, 3.1e-4, warm=3, frames=2)
        profile_section(tmp, device, -1.0, warm=2, frames=1)
        kernel_ab_section(tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
