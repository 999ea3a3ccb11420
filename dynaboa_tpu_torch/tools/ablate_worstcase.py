#!/usr/bin/env python
"""Attribute the worst-case (8-updates-per-frame) step cost to its parts, on
one CUDA card (counterpart of ``tools/ablate_worstcase.py``).

The dynamic-BOA protocol (reference dynaboa_benchmark.py:161-192) prices each
extra update at one batched loss forward + backward (frame, motion history,
retrieved exemplar), one teacher forward, Adam + teacher EMA and one
post-update forward.  Each variant below removes one part from the bf16
base (the JAX tool's eight, in its order) and runs the worst case: the
similarity threshold at -1, so every frame takes 1 + ``optim_steps``
updates.  Each variant's first step is timed alone (it builds cuDNN's plans
and, in a fresh process, the skinning kernel), then ``--frames`` steps over
the bench's 8 frames, synchronised at both ends.

The card reads the same code up to 1.7x apart between calls, so the
variants run in turns, ``--repeats`` times in one process, each from a
fresh state of its own system (built once); medians are reported and every
run is kept.  ``ms_per_update_by_component`` is ``base`` minus each
variant, over 1 + ``optim_steps`` updates per frame.

Usage:
  python -m dynaboa_tpu_torch.tools.ablate_worstcase [--variants all]
      [--frames 24] [--repeats 3] [--device cuda] [--use_pallas_lbs 1]
      [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from dynaboa_tpu_torch.tools.bench import build, card_info, make_frames, sync


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def variants(base) -> dict:
    """label -> (config, compute_metrics): the JAX tool's eight variants,
    each one change from ``base``."""
    return {
        "base": (base, True),
        "base_norec": (base.replace(record_dynamic=False), True),
        "no_teacher": (base.replace(use_meanteacher=False), True),
        "no_metrics": (base, False),
        "no_mixtrain": (base.replace(retrieval=False,
                                     lower_level_mixtrain=False,
                                     upper_level_mixtrain=False), True),
        "no_motion": (base.replace(use_motion=False), True),
        "fp32": (base.replace(compute_dtype="float32"), True),
        "no_inner": (base.replace(use_boa=False), True),
    }


def measure(cfg, label, n_frames=24, compute_metrics=True, *,
            device="cuda", tiny=False, system=None):
    """Worst-case ms per frame of one variant from a fresh state; builds
    the system unless given one."""
    if system is None:
        system = build(cfg, device, tiny, compute_metrics)
    frames = make_frames(8, device)
    engine = system.engine
    state = engine.init_state(system.params)
    t0 = time.perf_counter()
    state, out = engine.step(state, frames[0], cos_sim_threshold=-1.0)
    sync(device)
    first_s = time.perf_counter() - t0
    log(f"[{label}] first step: {first_s:.2f}s")

    extra = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        state, out = engine.step(state, frames[(i + 1) % len(frames)],
                                 cos_sim_threshold=-1.0)
        # the single-level step (use_boa=False) takes one update, no extras
        extra.append(out.get("optim_steps", 0))
    sync(device)
    dt = time.perf_counter() - t0
    ms_frame = 1000.0 * dt / n_frames
    log(f"[{label}] {n_frames} frames -> {ms_frame:.2f} ms/frame "
        f"({n_frames / dt:.2f} fps)")
    return dict(label=label, ms_per_frame=ms_frame, fps=n_frames / dt,
                first_step_s=first_s,
                extra_steps=sum(extra) / len(extra))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None,
                   help="also write the result here (JSON)")
    p.add_argument("--variants", default="all",
                   help="comma-separated labels, or all")
    p.add_argument("--frames", type=int, default=24,
                   help="timed frames per run")
    p.add_argument("--repeats", type=int, default=3,
                   help="runs of every variant, in turns")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--use_pallas_lbs", type=int, default=1, choices=[0, 1],
                   help="Hopper skinning kernel for the no-grad decodes")
    p.add_argument("--tiny", type=int, default=0, choices=[0, 1],
                   help="smoke mode: tiny network and body model")
    return p


def main(argv=None) -> dict:
    from dynaboa_tpu_torch.apps.common import require_device
    from dynaboa_tpu_torch.config import AdaptConfig

    args = build_parser().parse_args(argv)
    device = require_device(args.device)
    if args.repeats < 1 or args.frames < 1:
        raise SystemExit("--repeats and --frames must be at least 1")
    log("device:", card_info(device))
    base = AdaptConfig(record_lowerlevel=False, compute_dtype="bfloat16",
                       use_pallas_lbs=bool(args.use_pallas_lbs))
    table = variants(base)
    if args.variants != "all":
        keep = args.variants.split(",")
        unknown = sorted(set(keep) - set(table))
        if unknown:
            raise SystemExit(f"unknown variants {unknown}; expected labels "
                             f"of {list(table)}")
        table = {k: v for k, v in table.items() if k in keep}

    systems = {}
    for label, (cfg, metrics) in table.items():
        t0 = time.perf_counter()
        systems[label] = build(cfg, device, bool(args.tiny), metrics)
        log(f"[{label}] built in {time.perf_counter() - t0:.1f}s")
    runs = {label: [] for label in table}
    for _ in range(args.repeats):
        for label, (cfg, metrics) in table.items():
            runs[label].append(measure(
                cfg, label, args.frames, metrics, device=device,
                system=systems[label]))

    rows = []
    for label, rs in runs.items():
        rows.append(dict(
            label=label,
            ms_per_frame=statistics.median(r["ms_per_frame"] for r in rs),
            fps=statistics.median(r["fps"] for r in rs),
            extra_steps=rs[0]["extra_steps"],
            ms_per_frame_runs=[r["ms_per_frame"] for r in rs],
            fps_runs=[r["fps"] for r in rs],
            first_step_s_runs=[r["first_step_s"] for r in rs]))
    n_upd = 1 + base.optim_steps
    med = {r["label"]: r["ms_per_frame"] for r in rows}
    per_update = ({k: (med["base"] - v) / n_upd for k, v in med.items()
                   if k != "base"} if "base" in med else {})
    for k, v in per_update.items():
        log(f"[{k}] base minus variant: {v:.3f} ms/update")
    result = {"variants": rows, "ms_per_update_by_component": per_update,
              "updates_per_frame": n_upd, "frames": args.frames,
              "repeats": args.repeats,
              "use_pallas_lbs": bool(args.use_pallas_lbs),
              **card_info(device)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
