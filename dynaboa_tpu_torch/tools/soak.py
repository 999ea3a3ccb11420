#!/usr/bin/env python
"""Long-run soak of the port's adaptation runtime (counterpart of the root
``tools/soak.py``).

Two arms:

* ``sequential``: synthetic frames through ``StreamRunner`` with periodic
  checkpoints, a kill at half (the runner is dropped) and a fresh runner
  that resumes from ``checkpoint.npz``, and a NaN frame at N/3 that must
  trigger ``auto_reset``, while host RSS stays bounded and frames/s stays
  stable from window to window.  ``--bitexact`` adds a straight run on the
  same checkpoint cadence, whose final state must equal the resumed run's
  leaf for leaf; on the card all three runs use deterministic algorithms.
* ``parallel``: a 37-track synthetic stream partitioned lazily over
  ``--streams`` streams and adapted by ``run_parallel`` on one device; the
  RSS the partition and the run add over the system warmed by one step
  must stay under ``--rss_limit_mb`` and the in-run RSS floor must not
  grow.

The result is one JSON object, printed and merged into ``--out`` under the
arm's name (``parallel_<backend>`` off the CPU), beside ``card``: the name
and power limit of the card, as nvidia-smi gives them.

Usage:
  python -m dynaboa_tpu_torch.tools.soak sequential --frames 2500 --out s.json
  python -m dynaboa_tpu_torch.tools.soak parallel --frames 35000 \\
      --streams 8 --tiny --out s.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import time

import numpy as np
import torch


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def peak_rss_mb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class NaNInjectStream:
    """Wraps a stream, replacing the image of chosen frames with NaNs:
    drives the runner's divergence detection and ``auto_reset`` the way a
    real adaptation blow-up would.  ``rss_every`` > 0 records (and prints)
    host RSS on every ``rss_every``-th item access."""

    def __init__(self, base, nan_at=(), rss_every=0):
        self.base = base
        self.nan_at = set(nan_at)
        self.rss_every = rss_every
        self.samples: list[tuple[int, float]] = []

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        if self.rss_every and i % self.rss_every == 0:
            self.samples.append((i, rss_mb()))
            print(f"  [rss@frame {i}: {self.samples[-1][1]:.1f} MB]",
                  flush=True)
        it = dict(self.base[i])
        if i in self.nan_at:
            it["image"] = np.full_like(it["image"], np.nan)
        return it

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _flagship_cfg(compute_dtype):
    """The JAX soak's config, with the no-grad decodes through the skinning
    kernel as in the bench."""
    from dynaboa_tpu_torch.config import AdaptConfig

    return AdaptConfig(record_lowerlevel=False, compute_dtype=compute_dtype,
                       use_pallas_lbs=True)


def build_tiny_system(device, compute_dtype="bfloat16"):
    from dynaboa_tpu_torch.tools.bench import build

    cfg = _flagship_cfg(compute_dtype)
    return build(cfg, device, tiny=True), cfg


def build_full_system(device, compute_dtype="bfloat16"):
    from dynaboa_tpu_torch.tools.bench import build

    cfg = _flagship_cfg(compute_dtype)
    return build(cfg, device), cfg


def _build(args):
    build = build_tiny_system if args.tiny else build_full_system
    return build(args.device, args.compute_dtype)


def state_leaves(state) -> list[np.ndarray]:
    """Every leaf of an adaptation state on the host: the checkpoint's
    leaves (params, teacher, Adam count and moments, history, step, seed)
    and the generator's full state."""
    from dynaboa_tpu_torch.engine.checkpoint import _state_leaves

    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
            for x in _state_leaves(state)] + [state.rng.get_state().numpy()]


def compare_states(a, b) -> dict:
    """Leaf-by-leaf equality of two states (NaN equal to NaN)."""
    diffs = []
    for x, y in zip(state_leaves(a), state_leaves(b), strict=True):
        if not (x.shape == y.shape and x.dtype == y.dtype
                and np.array_equal(x, y, equal_nan=True)):
            diffs.append(float(np.nanmax(np.abs(
                x.astype(np.float64) - y.astype(np.float64)))))
    return {"exact": not diffs, "mismatched_leaves": len(diffs),
            "max_abs_diff": max(diffs) if diffs else 0.0}


def check(cond: bool, msg) -> None:
    if not cond:
        raise RuntimeError(msg)


def soak_sequential(args) -> dict:
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import StreamRunner
    from dynaboa_tpu_torch.tools.bench import deterministic

    system, cfg = _build(args)
    N = args.frames
    ckpt_every = args.checkpoint_every
    nan_at = {N // 3}              # one injected divergence
    stream = NaNInjectStream(SyntheticStream(num_frames=N, seed=11),
                             nan_at=nan_at, rss_every=args.rss_every)
    exp = args.expdir
    half = (N // 2 // ckpt_every) * ckpt_every
    check(half > 0, f"--checkpoint_every {ckpt_every} leaves no checkpoint "
          f"before the kill at half of {N} frames")
    # a checkpoint left by an earlier soak must not be resumed from
    for d in (exp, exp + "_ctl"):
        if osp.exists(osp.join(d, "checkpoint.npz")):
            os.remove(osp.join(d, "checkpoint.npz"))
    rss0 = rss_mb()
    # bit-equality on the card needs deterministic algorithms in every run
    det = (deterministic() if args.bitexact
           else contextlib.nullcontext([]))

    def runner_for(path):
        return StreamRunner(system.engine, path, checkpoint_every=ckpt_every,
                            log_every=args.log_every)

    with det as nondet:
        # phase A: run to just past half, checkpointing periodically, then
        # stop (a kill: the runner object is dropped)
        runner = runner_for(exp)
        state = system.engine.init_state(system.params)
        t0 = time.time()
        try:
            runner.run(stream, state, max_frames=half, auto_reset=True)
        finally:
            runner.close()
        resets_a = runner.reset_count
        frames_a = runner.frames_seen
        rss_a = rss_mb()
        wall_a = time.time() - t0

        # phase B: a fresh runner resumes from the checkpoint and finishes
        stream.samples = []
        runner2 = runner_for(exp)
        state2 = system.engine.init_state(system.params)
        t0 = time.time()
        try:
            resumed_final, _ = runner2.run(
                stream, state2, resume_from=osp.join(exp, "checkpoint.npz"),
                auto_reset=True)
        finally:
            runner2.close()
        wall_b = time.time() - t0
        rss_b = rss_mb()

        # arm C: the same stream straight through from the same weights, on
        # the same checkpoint cadence (a checkpoint is a flush boundary, and
        # a reset applies at the flush that finds the divergence)
        bitexact = None
        if args.bitexact:
            stream.rss_every = 0
            runner3 = runner_for(args.expdir + "_ctl")
            state3 = system.engine.init_state(system.params)
            t0 = time.time()
            try:
                final3, _ = runner3.run(stream, state3, auto_reset=True)
            finally:
                runner3.close()
            wall_c = time.time() - t0
            bitexact = {
                "resets_match": runner3.reset_count
                == runner2.reset_count + resets_a,
                **compare_states(resumed_final, final3),
                "control_wall_seconds": round(wall_c, 1),
            }
    if args.bitexact:
        print(f"[bitexact] resumed-vs-straight state: {bitexact}; ops "
              f"without a deterministic implementation: "
              f"{nondet or 'none reported'}", flush=True)

    def fps_windows(r, W=500):
        st = r.step_times[r._first_flush_frames or 32:]
        if len(st) >= W:
            return [round(1.0 / float(np.mean(st[i:i + W])), 2)
                    for i in range(0, len(st) - W + 1, W)]
        return [round(1.0 / float(np.mean(st)), 2)] if st else []

    st = runner2.step_times[runner2._first_flush_frames or 32:]
    res = {
        "arm": "sequential_bitexact" if args.bitexact else "sequential",
        "frames_total": N,
        "tiny": bool(args.tiny),
        "compute_dtype": cfg.compute_dtype,
        "phase_a_frames": frames_a,
        "phase_b_frames": runner2.frames_seen,
        "resumed_at": int(half),
        "every_frame_seen_once": frames_a + runner2.frames_seen == N,
        "injected_nan_frames": sorted(nan_at),
        "auto_resets": resets_a + runner2.reset_count,
        "checkpoints_skipped": runner.ckpt_skipped + runner2.ckpt_skipped,
        "rss_mb": {"start": round(rss0, 1), "after_phase_a": round(rss_a, 1),
                   "end": round(rss_b, 1), "peak": round(peak_rss_mb(), 1)},
        "rss_growth_phase_b_mb": round(rss_b - rss_a, 1),
        "rss_steady_growth_mb": _steady_growth(stream.samples, half),
        "fps_windows_500_phase_a": fps_windows(runner),
        "fps_windows_500": fps_windows(runner2),
        "fps_steady": round(1.0 / float(np.mean(st)), 2) if st else None,
        "extra_steps_mean": (round(float(np.mean(runner2.optim_step_record)),
                                   2) if runner2.optim_step_record else None),
        "extra_steps_p90": (float(np.percentile(runner2.optim_step_record, 90))
                            if runner2.optim_step_record else None),
        "wall_seconds": round(wall_a + wall_b, 1),
    }
    if bitexact is not None:
        res["bitexact_resume"] = bitexact
        check(bitexact["exact"], "kill+resume final state differs from the "
              f"straight run: {bitexact}")
    check(res["every_frame_seen_once"], res)
    check(res["auto_resets"] >= 1, "injected NaN did not trigger auto_reset")
    growth = res["rss_steady_growth_mb"]
    if args.bitexact:
        # a bitexact run is short (its claim is state equality, not RSS);
        # phase B may not reach the steady-sample region
        check(growth is None or growth < args.rss_growth_limit_mb, res)
    else:
        check(growth is not None and growth < args.rss_growth_limit_mb, res)
    return res


def _steady_growth(samples, resumed_at):
    """Growth of the RSS floor across phase B's steady region: min of the
    last-half samples minus min of the first-half samples (past the resume
    load).  None without >= 4 steady samples."""
    steady = [r for i, r in samples if i >= resumed_at + 250]
    if len(steady) < 4:
        return None
    h = len(steady) // 2
    return round(min(steady[h:]) - min(steady[:h]), 1)


def soak_parallel(args) -> dict:
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import frame_from_item
    from dynaboa_tpu_torch.parallel.streams import (partition_items,
                                                    run_parallel)
    from dynaboa_tpu_torch.tools.bench import parallel_devices

    rss0 = rss_mb()
    system, cfg = _build(args)
    N, S = args.frames, args.streams

    class TrackedSynthetic(SyntheticStream):
        # 3DPW's 37 (sequence, person) tracks: whole tracks per stream,
        # round robin
        @property
        def seq_lengths(self):
            n_tracks = 37
            per = self.n // n_tracks
            tail = self.n - per * (n_tracks - 1)
            return [per] * (n_tracks - 1) + [tail]

    stream = TrackedSynthetic(num_frames=N, seed=13)
    # one step before the baseline: the CUDA libraries (cuDNN, cuBLAS) load
    # into host memory at the first step, gigabytes once, which do not grow
    # with the stream
    system.engine.step(system.engine.init_state(system.params),
                       frame_from_item(stream[0], system.device))
    rss_warm = rss_mb()
    groups = partition_items(stream, S)
    samples: list[float] = []

    def log_progress(msg):
        samples.append(rss_mb())
        print(msg, flush=True)

    t0 = time.time()
    summary = run_parallel(system.engine, system.params, groups,
                           devices=parallel_devices(system.device),
                           log=log_progress,
                           progress_every=max(args.rss_every * 8, 256))
    # growth of the in-run RSS floor (min of halves): what grows with
    # stream length; the peak is reported, not bounded
    h = len(samples) // 2
    steady_growth = (round(min(samples[h:]) - min(samples[:h]), 1)
                     if len(samples) >= 4 else None)
    end = rss_mb()
    res = {
        "arm": "parallel",
        "frames_total": N,
        "streams": S,
        "tiny": bool(args.tiny),
        "frames_run": summary["frames"],
        "aggregate_fps": round(summary["fps"], 2),
        "mpjpe": round(summary["mpjpe"], 3),
        "rss_mb": {"start": round(rss0, 1),
                   "after_warmup": round(rss_warm, 1),
                   "end": round(end, 1), "peak": round(peak_rss_mb(), 1)},
        "rss_steady_growth_mb": steady_growth,
        "wall_seconds": round(time.time() - t0, 1),
    }
    check(res["frames_run"] == N, res)
    # the bound is on what the partition and the run add over the warmed
    # system: on the card the CUDA context and libraries alone hold
    # gigabytes of host RSS, and they do not grow with the stream
    check(end - rss_warm < args.rss_limit_mb,
          f"the run added {end - rss_warm:.1f} MB of RSS over the warmed "
          f"system, beyond the {args.rss_limit_mb} MB bound: the lazy "
          "partition is leaking")
    if steady_growth is not None:
        check(steady_growth < args.rss_growth_limit_mb, res)
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arm", choices=["sequential", "parallel"])
    ap.add_argument("--frames", type=int, default=2500)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--bitexact", action="store_true",
                    help="sequential arm: also run a straight-through "
                    "control and require the kill+resume final state to "
                    "equal it leaf for leaf")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--checkpoint_every", type=int, default=250)
    ap.add_argument("--log_every", type=int, default=500)
    ap.add_argument("--rss_limit_mb", type=float, default=2048.0)
    ap.add_argument("--rss_growth_limit_mb", type=float, default=500.0)
    ap.add_argument("--rss_every", type=int, default=80,
                    help="record host RSS every N item loads")
    ap.add_argument("--expdir", default="exps/soak")
    ap.add_argument("--out", required=True)
    return ap


def main(argv=None) -> dict:
    from dynaboa_tpu_torch.apps.common import require_device
    from dynaboa_tpu_torch.tools.bench import card_info

    args = build_parser().parse_args(argv)
    args.device = require_device(args.device)
    card = card_info(args.device)
    res = (soak_sequential(args) if args.arm == "sequential"
           else soak_parallel(args))
    res["backend"] = card["backend"]

    existing = {}
    if osp.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    key = res["arm"]
    if key == "parallel" and res["backend"] != "cpu":
        key = f"parallel_{res['backend']}"
    existing[key] = res
    existing["card"] = (None if card["power_limit"] is None else
                        f"{card['device_name']}, {card['power_limit']}")
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
