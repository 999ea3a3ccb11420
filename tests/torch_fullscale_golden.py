#!/usr/bin/env python
"""Record the JAX package's full-width composed run that the port is held
against (``dynaboa_tpu_torch/tools/fullscale_parity.py``).

  python tests/torch_fullscale_golden.py [--out PATH] [--arms ...]
  python tests/torch_fullscale_golden.py --out PATH --merge A.npz B.npz ...

Runs the tool's three arms through the JAX engine on the CPU, at matmul
precision ``highest`` with the persistent compilation cache, from the
tool's recipe (the same numpy seeds, weights and cluster centres the port
draws), and writes ``dynaboa_tpu_torch/assets/fullscale_jax.npz``: each
arm's config, the recipe's version, the jax / jaxlib versions and the
backend, the initial-weight and centre checksums, per frame the step count,
losses, sims, upper aux terms and metrics, the first and last frame's
vertices, the final params and teacher at up to 512 seeded coordinates per
leaf with each leaf's update norm, and the reference's own spread: each
arm again from the weights one ulp up and down (one compiled engine for
the three runs), each check's gap to the central run.  The JAX side
decodes with its eager ``lbs`` (Pallas off).  About an hour of CPU at full
width: run it in the background, one process per arm (``--arms``, each to
its own ``--out``), then ``--merge`` the three.

Not a test module (pytest collects ``test_*.py`` only);
``tests/test_torch_fullscale.py`` calls ``record`` at the tiny size.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dynaboa_tpu import engine as jeng  # noqa: E402
from dynaboa_tpu.config import AdaptConfig  # noqa: E402
from dynaboa_tpu.losses import synthetic_gmm_prior  # noqa: E402
from dynaboa_tpu.metrics import GenderedSMPL  # noqa: E402
from dynaboa_tpu.models import synthetic_smpl_model  # noqa: E402
from dynaboa_tpu.models.hmr import HMR, convert_torch_state_dict  # noqa: E402

from dynaboa_tpu_torch.models.hmr import params_from_jax  # noqa: E402
from dynaboa_tpu_torch.tools import fullscale_parity as fp  # noqa: E402


def record_arm(arm: str, size: str, n_frames: int, weights: dict,
               centers: np.ndarray, meta: dict):
    """One arm through the JAX engine from ``weights`` and from them one ulp
    up and down: ``(arm_meta, arrays)`` in the form of ``fp.run_port``'s,
    the arrays with the reference's spread (``fp.spread``) added."""
    S = fp.SIZES[size]
    fields, thr = fp.ARMS[arm]
    cfg = AdaptConfig(**fields)
    model = HMR(layers=S.layers, width=S.width, regressor_dim=S.rdim)
    smpls = GenderedSMPL(
        neutral=synthetic_smpl_model(seed=10, num_vertices=S.nv),
        male=synthetic_smpl_model(seed=11, num_vertices=S.nv),
        female=synthetic_smpl_model(seed=12, num_vertices=S.nv),
        J_regressor_h36m=jnp.asarray(fp.h36m_regressor(S.nv)))
    bank = fp.exemplar_bank(S)
    store = jeng.retrieval.build_store(
        centers, [[i] for i in range(fp.N_CLUSTERS)],
        jeng.retrieval.ExemplarBank(*[jnp.asarray(a.numpy()) for a in bank
                                      if a is not None]))
    engine = jeng.BilevelEngine(cfg, model, synthetic_gmm_prior(seed=4),
                                smpls, store)
    frames = [jeng.Frame(**{k: jnp.asarray(v) for k, v in fr.items()})
              for fr in fp.make_frames(n_frames, S.img)]

    def port_layout(tree):
        return {k: v.numpy() for k, v in params_from_jax(tree).items()}

    def run(w):
        params = convert_torch_state_dict(
            {k: torch.as_tensor(v) for k, v in w.items()},
            scan_blocks=False)[0]
        state = engine.init_state(params, img_res=S.img)
        outs = []
        for fr in frames:
            state, o = engine.step(state, fr, cos_sim_threshold=thr)
            outs.append(jax.tree.map(np.asarray, o))
        return fp.summarize(outs, w, port_layout(state.params),
                            port_layout(state.teacher_params))

    arm_meta = {"config": dataclasses.asdict(cfg), "thr": thr}
    central = run(weights)
    others = [run(fp.ulp_moved(weights, sign)) for sign in (1, -1)]
    meta = {**meta, "arms": {arm: arm_meta}}
    return arm_meta, {**central, **fp.spread(meta, arm, central, others)}


def record(size: str = "full", n_frames: int = fp.N_FRAMES,
           arms=tuple(fp.ARMS), log=print) -> dict:
    """The record of ``arms``: ``{"meta": ..., "arms": {arm: arrays}}``."""
    import jaxlib

    S = fp.SIZES[size]
    weights = fp.draw_weights(S)
    centers = fp.cluster_centers(S, weights, n_frames)
    rec = {"meta": fp.run_meta(size, n_frames, weights, centers),
           "centers": centers, "arms": {}}
    rec["meta"].update(jax=jax.__version__, jaxlib=jaxlib.__version__,
                       backend=jax.default_backend())
    for arm in arms:
        t0 = time.time()
        with jax.default_matmul_precision("highest"):
            meta, rec["arms"][arm] = record_arm(arm, size, n_frames, weights,
                                                centers, rec["meta"])
        meta["seconds"] = time.time() - t0
        rec["meta"]["arms"][arm] = meta
        log(f"{arm}: steps {rec['arms'][arm]['optim_steps'].tolist()} in "
            f"{meta['seconds']:.1f} s (three runs)")
    return rec


def merge(paths: list[str]) -> dict:
    """One record from records of the same recipe holding other arms."""
    recs = [fp.load_record(p) for p in paths]
    out = recs[0]
    for r in recs[1:]:
        same = {k: v for k, v in r["meta"].items() if k != "arms"}
        if (same != {k: v for k, v in out["meta"].items() if k != "arms"}
                or not np.array_equal(r["centers"], out["centers"])):
            raise ValueError("the records differ in their recipe")
        out["meta"]["arms"].update(r["meta"]["arms"])
        out["arms"].update(r["arms"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=fp.RECORD)
    ap.add_argument("--size", default="full", choices=list(fp.SIZES))
    ap.add_argument("--frames", type=int, default=fp.N_FRAMES)
    ap.add_argument("--arms", nargs="+", default=list(fp.ARMS),
                    choices=list(fp.ARMS))
    ap.add_argument("--merge", nargs="+", metavar="RECORD",
                    help="write the union of these records' arms instead")
    args = ap.parse_args(argv)

    if args.merge:
        rec = merge(args.merge)
    else:
        import dynaboa_tpu

        dynaboa_tpu.enable_compilation_cache()
        rec = record(args.size, args.frames, args.arms,
                     log=lambda s: print(s, flush=True))
    tmp = args.out + ".tmp.npz"
    fp.save_record(tmp, rec)
    os.replace(tmp, args.out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
