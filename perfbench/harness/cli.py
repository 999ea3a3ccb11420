"""One run of one cell: read ``BENCHMARK.json``, find the cell's
configuration, traffic mix, metrics and limits by name, look for the
chips, drive the window, read the metrics, run the check, and print the
result line."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
FORBIDDEN = ("jax", "jaxlib", "flax", "dynaboa_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def reader(name: str, root: str = ROOT):
    """The metric's reader, ``perfbench/metrics/<name>.py``'s ``read``."""
    from perfbench.harness import found

    return found.module("metrics", name, root).read


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def read_metrics(metrics: list[dict], r: dict, cfg: dict, root: str) -> dict:
    out = {}
    for m in metrics:
        v = reader(m["name"], root)(r, cfg)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def imported_forbidden() -> list[str]:
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def card_info(device) -> dict:
    import torch

    info = {"name": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
        info["power_limit"] = out.strip().splitlines()[
            device.index or 0].rsplit(",", 1)[1].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, t_start: float, device, control: bool = False,
             root: str = ROOT, overrides: dict | None = None,
             detail: dict | None = None):
    """Drive one run of ``workload`` on ``device`` and judge it.  Returns
    (result dict without ``device``, readings, the check's numbers, and with
    ``control`` also the TF32 reference's numbers against the float32
    one).  Configurations, traffic mixes, entries, frame sources,
    schedules, metric readers and limits are found by name under ``root``
    (a checkout's root).  ``overrides`` changes the program's ``adapt``
    settings and not the reference's (a planted fault); ``detail``
    collects each compared number's worst parts."""
    import torch

    from perfbench.harness import check, found, replay, traffic

    wl = find(bench["workloads"], workload, "workload")
    cspec = find(bench["configs"], wl["config"], "config")
    cfg = load_json(os.path.join(root, cspec["file"]))
    mix = traffic.load(wl["traffic"], root)
    run = SimpleNamespace(cfg=cfg, mix=mix, device=device, seed=int(seed),
                          seconds=float(seconds), trace=traced,
                          t_start=t_start, root=root, overrides=overrides)
    entry = found.module("entries", mix["entry"], root)
    r = entry.drive(run)
    kind = "per_layer" if traced else "end_to_end"
    metrics = read_metrics(cell_metrics(bench, workload, kind), r, cfg, root)

    chk = r["check"]
    prog = entry.program_side(chk)
    ref = entry.reference_side(cfg, chk, device)
    numbers = replay.compare(cfg, chk, prog, ref, detail)
    ctrl = None
    if control:
        ctrl = replay.compare(cfg, chk, entry.reference_side(
            cfg, chk, device, control=True), ref)
    limits = load_json(os.path.join(root, "perfbench", "limits",
                                    f"{workload}.json"))
    ok, shown = check.verdict(numbers, limits)
    result = {"correct": bool(ok and r["failed"] == 0),
              "attempted": r["frames"], "failed": r["failed"],
              "metrics": metrics}
    if traced:
        from perfbench.harness.trace import breakdown
        result["breakdown"] = breakdown(r["trace"])
    result["checks"] = shown
    del r["check"]
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return result, r, numbers, ctrl


def process_start(now: float) -> float:
    """``time.perf_counter()`` at this process's start, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def main(argv, t_import: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    t_start = process_start(t_import)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = find(bench["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    # float32 means float32: the configurations run with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result, r, numbers, _ = run_cell(bench, args.workload, args.seed,
                                     args.seconds, bool(args.trace), t_start,
                                     device)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": wl["chips"], "memory_peak_bytes": r["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"] = r["trace"]["busy_s"]
        dev["window_s"] = r["trace"]["window_s"]
    bad = imported_forbidden()
    if bad:
        print(f"perfbench: the run imported {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    line = dict(result, device=dev, card=card_info(device),
                compared_frames=numbers.get("compared_frames"),
                checks=checks)
    print(json.dumps(finite(line)))
    sys.stdout.flush()
    print("setup seconds since process start, by the end of: " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["setup_parts"].items()), file=sys.stderr)
    print("frames a second by thirds of the window: " + ", ".join(
        f"{v:.4f}" for v in r["thirds"]), file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    return 0


def finite(x):
    """JSON-safe copy: a non-finite float becomes its name as a string."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x
