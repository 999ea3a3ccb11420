"""HMR 2.0 at the published widths through ``BilevelEngine.step`` on a card:
the CUDA graphs of its gradient evaluations against the same engine run
eagerly, over 8 frames at the per-frame caps of the benchmark's traced
segment (0, 7, 0, 6, 1, 3, 1, 3; threshold -1), with the configuration and
the seeded inputs of ``perfbench/configs/hmr2_vith_3dpw.json``.

These tests need a CUDA card and skip without one.  The file imports no jax
(the card's machine has none), so on the card it runs without the suite's
conftest:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hmr2_cuda.py
"""

import json
import math
import os

import pytest
import torch

from test_torch_graphs_cuda import TOL, WARM_FRAMES, eager_twin, run_pair

from dynaboa_tpu_torch.engine.bilevel import Frame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _frames(n, device, res, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        xy = torch.rand((1, 49, 2), generator=g, device=device) * 2 - 1
        out.append(Frame(
            image=torch.randn((1, res, res, 3), generator=g, device=device),
            j2d=torch.cat([xy, torch.ones((1, 49, 1), device=device)], -1),
            pose=torch.zeros((1, 72), device=device),
            betas=torch.zeros((1, 10), device=device),
            gender=torch.zeros((1,), dtype=torch.int32, device=device)))
    return out


@pytest.fixture(scope="module")
def runs(cuda_device):
    """HMR 2.0 adapting over 8 frames through its graphs, against an eager
    twin stepped from a copy of its state at each frame."""
    import sys

    sys.path.insert(0, ROOT)
    from perfbench.harness import found

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = found.module("entries", "hmr2_step", ROOT)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "hmr2_vith_3dpw.json")) as f:
        cfg = json.load(f)
    inp = entry.make_inputs(cfg, 20261018, cuda_device)
    system = entry.build_system(cfg, inp, cuda_device)
    engine = system.engine.engine
    torch.cuda.reset_peak_memory_stats(cuda_device)
    graphed = run_pair(engine, eager_twin(system, system.cfg, True),
                       system.params,
                       _frames(N_FRAMES, cuda_device, cfg["model"]["img_res"]))
    graphed["peak_bytes"] = torch.cuda.max_memory_allocated(cuda_device)
    return graphed


@pytest.mark.cuda
def test_graphed_steps_equal_eager(runs):
    """Losses and their terms, predictions and Adam's moments of each
    graphed step against the eager step from the same state, to the
    HMR configurations' ``TOL``."""
    gaps = runs["gaps"]
    print(f"\nhmr2: graphed against eager {gaps}; peak "
          f"{runs['peak_bytes']} B with the eager twin")
    assert all(math.isfinite(v) and v <= TOL[k] for k, v in gaps.items()), \
        gaps


@pytest.mark.cuda
def test_three_keys_captured_in_the_warm_up_and_none_after(runs):
    stats = runs["stats"]
    warm = stats[WARM_FRAMES - 1]
    assert warm["eager"] == warm["captures"] == runs["keys"] == 3
    last = stats[-1]
    assert (last["eager"], last["captures"]) == (warm["eager"],
                                                 warm["captures"])
    evaluations = sum(1 + int(o["optim_steps"]) + 1
                      for o in runs["outs"][WARM_FRAMES:])
    assert last["replays"] - warm["replays"] == evaluations
    print(f"\nhmr2 graph_stats after the warm-up {warm}, after 8 frames "
          f"{last}")
