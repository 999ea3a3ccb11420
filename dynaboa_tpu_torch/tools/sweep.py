#!/usr/bin/env python
"""Flag-grid sweep over the port's benchmark CLI (counterpart of the root
``tools/sweep.py``): ``apps/benchmark.main`` once per combination, each
run's summary one JSONL record.

Hosts shard the grid: host I of N runs combinations I, I+N, I+2N, ... and
writes ``sweep_results_host<I>.jsonl`` under ``--out``; concatenate the
shards.  ``--device`` travels in ``--base`` (the CLI's default is cuda).

Usage:
  python -m dynaboa_tpu_torch.tools.sweep --grid lr=1e-6,3e-6 interval=2,5 \\
      --base "--synthetic 8 --tiny 1 --device cpu" --out exps/sweep \\
      [--host_id 0 --num_hosts 1]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time


def parse_grid(specs: list[str]) -> list[dict]:
    """['lr=1e-6,3e-6', 'interval=2,5'] -> list of flag dicts (product)."""
    axes = []
    for spec in specs:
        name, _, values = spec.partition("=")
        if not values:
            raise ValueError(f"grid spec '{spec}' needs name=v1,v2,...")
        axes.append([(name, v) for v in values.split(",")])
    return [dict(combo) for combo in itertools.product(*axes)]


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", nargs="+", required=True,
                    help="flag grids, e.g. lr=1e-6,3e-6 interval=2,5")
    ap.add_argument("--base", type=str, default="",
                    help="flags shared by every run (one quoted string)")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--host_id", type=int, default=0)
    ap.add_argument("--num_hosts", type=int, default=1)
    args = ap.parse_args(argv)

    from dynaboa_tpu_torch.apps import benchmark

    combos = parse_grid(args.grid)
    mine = combos[args.host_id::args.num_hosts]
    os.makedirs(args.out, exist_ok=True)
    results_path = os.path.join(args.out,
                                f"sweep_results_host{args.host_id}.jsonl")
    print(f"host {args.host_id}/{args.num_hosts}: "
          f"{len(mine)} of {len(combos)} combinations")

    with open(results_path, "w") as f:
        for n, combo in enumerate(mine):
            tag = "_".join(f"{k}{v}" for k, v in sorted(combo.items()))
            flags = args.base.split()
            for k, v in combo.items():
                flags += [f"--{k}", str(v)]
            flags += ["--expdir", args.out, "--expname", f"run_{tag}"]
            print(f"[{n + 1}/{len(mine)}] {tag}: {' '.join(flags)}")
            t0 = time.time()
            summary = benchmark.main(flags)
            rec = {"combo": combo, "expname": f"run_{tag}",
                   "wall_s": round(time.time() - t0, 2), **summary}
            f.write(json.dumps(rec) + "\n")
            f.flush()
    print(f"wrote {results_path}")
    return results_path


if __name__ == "__main__":
    main()
