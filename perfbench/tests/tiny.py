"""A checkout-shaped tree with the benchmark's cells cut to a size the CPU
runs in seconds: every file of ``perfbench/`` that the harness finds by
name, with the configurations' network and bodies shrunk (width 8, one
block a stage, regressor 32, V = 400) and the store cut to 2 x 4."""

from __future__ import annotations

import json
import os
import shutil

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)


def shrink(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["model"].update(width=8, layers=[1, 1, 1, 1], regressor_dim=32)
    cfg["smpl"].update(num_vertices=400, num_faces=700)
    if cfg["store"]:
        cfg["store"].update(clusters=2, per_cluster=4)
    return cfg


def make_tree(dest: str) -> tuple[str, dict]:
    """Copy the benchmark's data files and readers under ``dest`` with the
    configurations shrunk; returns (root, the BENCHMARK.json dict)."""
    for sub in ("traffic", "metrics", "limits", "configs", "entries",
                "sources", "schedules"):
        shutil.copytree(os.path.join(PB, sub), os.path.join(dest, "perfbench",
                                                            sub))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dest, c["file"])
        with open(path) as f:
            cfg = shrink(json.load(f))
        with open(path, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest, bench


def run(root: str, bench: dict, workload: str, seed: int = 20251017,
        seconds: float = 3.0, traced: bool = False, control: bool = False,
        device: str = "cpu", overrides: dict | None = None,
        detail: dict | None = None):
    import time

    import torch

    from perfbench.harness import cli

    return cli.run_cell(bench, workload, seed, seconds, traced,
                        time.perf_counter(), torch.device(device),
                        control=control, root=root, overrides=overrides,
                        detail=detail)
