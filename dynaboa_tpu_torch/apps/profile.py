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
  6. windowed adaptation (B = W = 8, fused preprocessing) against the
     per-frame path in one process, in turns (window, frames, frames,
     window, ...): median wall ms per frame of each, then one profiled
     window step: device time by op, kernel count and idle share
  7. checkpoints and determinism: the windowed CLI of chip_smoke.py phase 5
     with --checkpoint_every 16 against none (3 pairs, alternating):
     the tail window step's seconds with and without a write in flight; the
     time of one checkpoint's device snapshot, device-to-host copy and
     blocking save at W = 8; then the resume runs of phase 6 without and
     with deterministic algorithms: run-to-run and resumed differences by
     part of the state, and seconds per window step
  8. section 4's profile at the default threshold with the backbone in
     float32 and in bfloat16 (--compute_dtype), one after the other in one
     process: device time by op, kernel count, idle share and host time

  python -m dynaboa_tpu_torch.apps.profile --sections 6 7   # only 6 and 7
"""

from __future__ import annotations

import argparse
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
                    frames: int, compute_dtype: str = "float32") -> None:
    from dynaboa_tpu_torch.config import AdaptConfig, Paths
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import frame_from_item

    cfg = AdaptConfig(cos_sim_threshold=threshold, use_pallas_lbs=True,
                      compute_dtype=compute_dtype)
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
    label = f"thr={threshold} {compute_dtype}"
    print(f"--- profile {label}: {frames} frames after {warm} warm-up "
          f"frames; extra updates warm-up {warm_steps}, profiled {steps}")
    table = prof.key_averages()
    print(table.table(sort_by="self_device_time_total", row_limit=30,
                      max_name_column_width=60))
    host_ms = sum(e.self_cpu_time_total for e in table) / 1e3 / frames
    print(f"{label}: host self time {host_ms:.2f} ms per frame")
    trace = os.path.join(tmp, f"trace_{threshold}_{compute_dtype}.json")
    prof.export_chrome_trace(trace)
    kernels, busy, span = device_busy(trace)
    print(f"{label}: {kernels} device kernels over {frames} frames; busy "
          f"{busy} us of span {span} us -> idle share {1 - busy / span:.3f}",
          flush=True)


def kernel_ab_section(tmp: str, device: str, rounds: int = 4,
                      block: int = 4) -> None:
    from dynaboa_tpu_torch.config import AdaptConfig, Paths
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


def window_section(tmp: str, device: str, W: int = 8, rounds: int = 4,
                   warm: int = 2) -> None:
    from dynaboa_tpu_torch.config import AdaptConfig, Paths
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import (frame_from_item,
                                                 frame_from_window)

    system = build_system(AdaptConfig(use_pallas_lbs=True), Paths(), device)
    engine = system.engine
    states = {"window": engine.init_state(system.params, batch_size=W),
              "frames": engine.init_state(system.params, batch_size=1)}
    items = iter(SyntheticStream(num_frames=2 * W * (warm + rounds + 1),
                                 seed=22, fused_preprocess=True))

    def block(mode: str) -> float:
        """One window step, or W per-frame steps: wall s per frame."""
        batch = [next(items) for _ in range(W)]
        t0 = time.perf_counter()
        if mode == "window":
            states[mode], _ = engine.step(
                states[mode], frame_from_window(batch, device))
        else:
            for it in batch:
                states[mode], _ = engine.step(states[mode],
                                              frame_from_item(it, device))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / W

    for _ in range(warm):
        block("window")
        block("frames")
    times = {"window": [], "frames": []}
    for r in range(rounds):
        for mode in (("window", "frames") if r % 2 == 0
                     else ("frames", "window")):
            times[mode].append(block(mode))
    for mode, ts in times.items():
        med = statistics.median(ts)
        print(f"{mode}: median {med * 1e3:.2f} ms per frame = "
              f"{1.0 / med:.3f} frames/s over {len(ts)} blocks of {W} frames "
              f"{[round(t * 1e3, 2) for t in ts]}", flush=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        block("window")
    print(f"--- one profiled window step, W={W}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25, max_name_column_width=60))
    trace = os.path.join(tmp, "trace_window.json")
    prof.export_chrome_trace(trace)
    kernels, busy, span = device_busy(trace)
    print(f"window W={W}: {kernels} device kernels; busy {busy} us of span "
          f"{span} us -> idle share {1 - busy / span:.3f}", flush=True)


def checkpoint_section(tmp: str, device: str, rounds: int = 3) -> None:
    from dynaboa_tpu_torch.config import AdaptConfig
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.engine import checkpoint as ck

    # (a) the windowed CLI of chip_smoke.py phase 5 (20 frames, W = 8, a
    # chunk of 2 windows, then a 4-frame tail) with the checkpoint at frame
    # 16 in flight during the tail's window step, and without checkpoints
    W, frames, tail = 8, 20, 4
    window = ["--window_size", str(W), "--chunk_size", "2",
              "--fused_preprocess", "1", "--use_pallas_lbs", "1"]
    tails = {"ckpt16": [], "none": []}
    for r in range(rounds):
        for mode in (("ckpt16", "none") if r % 2 == 0 else ("none", "ckpt16")):
            extra = ["--checkpoint_every", "16"] if mode == "ckpt16" else []
            s = cli_run(tmp, f"window_{mode}_{r}", device, frames, *window,
                        *extra)
            tails[mode].append(tail / s["fps"])
    for mode, ts in tails.items():
        print(f"windowed CLI, checkpoints {mode}: tail window step "
              f"{[round(t, 4) for t in ts]} s, median "
              f"{statistics.median(ts):.4f} s", flush=True)

    # the write itself, at W = 8: the device snapshot, its device-to-host
    # copy and the whole blocking save
    system = build_system(AdaptConfig(use_pallas_lbs=True), None, device)
    state = system.engine.init_state(system.params, batch_size=W)
    path = os.path.join(tmp, "ck.npz")
    for _ in range(3):
        t0 = time.perf_counter()
        _, packed, _ = ck._pack_state(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = packed["float32"].cpu()
        t2 = time.perf_counter()
        ck.save_state(path, state)
        t3 = time.perf_counter()
        print(f"checkpoint W={W}: {host.numel() * 4 / 1e9:.3f} GB float32; "
              f"snapshot {t1 - t0:.4f} s, device-to-host {t2 - t1:.4f} s, "
              f"blocking save {t3 - t2:.4f} s", flush=True)
    del state, system, host, packed

    # (b) the resume configuration of phase 6 (12 frames at W = 4,
    # checkpoints every window) without and with deterministic algorithms:
    # run-to-run and resume differences by part of the state, and the cost
    def resume_runs(tag: str) -> dict:
        res = {}
        for name in ("a", "b"):
            res[name] = cli_run(tmp, f"{tag}_{name}", device, 12,
                                "--window_size", "4", "--use_pallas_lbs", "1",
                                "--checkpoint_every", "4")
        cli_run(tmp, f"{tag}_half", device, 12, "--window_size", "4",
                "--use_pallas_lbs", "1", "--checkpoint_every", "4",
                "--max_frames", "8")
        cli_run(tmp, f"{tag}_resumed", device, 12, "--window_size", "4",
                "--use_pallas_lbs", "1", "--checkpoint_every", "4",
                "--resume", os.path.join(tmp, f"{tag}_half",
                                         "checkpoint.npz"))
        ck_of = {n: os.path.join(tmp, f"{tag}_{n}", "checkpoint.npz")
                 for n in ("a", "b", "resumed")}
        print(f"{tag}: steady s per window step "
              f"{[round(4 / s['fps'], 4) for s in res.values()]}; run a vs b "
              f"{ck.group_diffs(ck_of['a'], ck_of['b'])}; a vs resumed "
              f"{ck.group_diffs(ck_of['a'], ck_of['resumed'])}", flush=True)
        return res

    resume_runs("nondeterministic")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        resume_runs("deterministic")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sections", type=int, nargs="*",
                   default=[1, 2, 3, 4, 5, 6, 7, 8])
    sections = set(p.parse_args(argv).sections)
    if not torch.cuda.is_available():
        raise SystemExit("the profile needs a CUDA device")
    device = "cuda"
    tmp = tempfile.mkdtemp(prefix="dynaboa_profile_")
    try:
        if 1 in sections:
            gmm_section(device)
        if 2 in sections:
            for r in range(ROUNDS):
                for lbs in ((1, 0) if r % 2 == 0 else (0, 1)):
                    cli_run(tmp, f"kernel_{'on' if lbs else 'off'}_{r}",
                            device, FRAMES, "--use_pallas_lbs", str(lbs))
        if 3 in sections:
            cli_run(tmp, "kernel_on_thr-1", device, FRAMES - 2,
                    "--use_pallas_lbs", "1", "--cos_sim_threshold", "-1")
        if 4 in sections:
            profile_section(tmp, device, 3.1e-4, warm=3, frames=2)
            profile_section(tmp, device, -1.0, warm=2, frames=1)
        if 5 in sections:
            kernel_ab_section(tmp, device)
        if 6 in sections:
            window_section(tmp, device)
        if 7 in sections:
            checkpoint_section(tmp, device)
        if 8 in sections:
            for dtype in ("float32", "bfloat16"):
                profile_section(tmp, device, 3.1e-4, warm=3, frames=2,
                                compute_dtype=dtype)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
