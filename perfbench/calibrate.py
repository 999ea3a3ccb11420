#!/usr/bin/env python3
"""Readings that the check's limits are set from, for one cell, in one
process: the check's numbers of sound runs over many seeds (the lower
readings), on some of them the control's, the reference computed with
TF32 on and put in the program's place (the upper readings), and with
``--fault`` the numbers of the program run with a planted fault in its
update rule.  A short window at the cell's own sizes and load is enough:
the check compares the same frames as a full run does.

  python3 perfbench/calibrate.py --workload pw3d.geo_updates \\
      --seeds 11 12 13 ... --control 11 12 13 --seconds 8
  python3 perfbench/calibrate.py --workload pw3d.geo_updates \\
      --seeds 11 12 13 --fault lr_x1.1 --seconds 8

Prints one JSON line per seed, then one with each number's largest and
smallest reading, and the control's smallest.  Needs a CUDA card.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness import cli  # noqa: E402

# Faults planted in the program's update rule: the program runs with these
# ``adapt`` settings, the reference with the configuration's.
FAULTS = {
    "lr_x1.1": lambda a: {"lr": a["lr"] * 1.1},
    "alpha_swapped": lambda a: {"alpha": 1.0 - a["alpha"]},
}


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--detail", type=int, default=0,
                    help="print each number's worst parts (leaves, terms)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cli.load_json(os.path.join(cli.ROOT, "BENCHMARK.json"))
    overrides = None
    if args.fault:
        wl = cli.find(bench["workloads"], args.workload, "workload")
        cspec = cli.find(bench["configs"], wl["config"], "config")
        cfg = cli.load_json(os.path.join(cli.ROOT, cspec["file"]))
        overrides = FAULTS[args.fault](cfg["adapt"])
    most, least, upper = {}, {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        detail = {} if args.detail else None
        res, r, nums, ctrl = cli.run_cell(
            bench, args.workload, seed, args.seconds, False, t0, device,
            control=seed in args.control, overrides=overrides, detail=detail)
        line = {"seed": seed, "fault": args.fault, "correct": res["correct"],
                "failed": r["failed"], "frames": r["frames"],
                "updates": r["updates"][:24], "numbers": nums,
                "control": ctrl}
        if args.detail:
            line["detail"] = sorted(detail.items(),
                                    key=lambda x: -x[1])[:args.detail]
            line["tree"] = {k: v for k, v in detail.items()
                            if k.endswith("(tree)")}
        print(json.dumps(cli.finite(line)), flush=True)
        for k, v in nums.items():
            most[k] = max(most.get(k, 0), v)
            least[k] = min(least.get(k, float("inf")), v)
        for k, v in (ctrl or {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps(cli.finite({"workload": args.workload,
                                 "fault": args.fault, "most": most,
                                 "least": least, "control_least": upper})),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
