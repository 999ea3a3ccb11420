#!/usr/bin/env python
"""3DPW #PS streaming benchmark on PyTorch: per-frame dynamic bilevel
adaptation + evaluation.

The argparse surface of ``dynaboa_tpu/apps/benchmark.py`` plus ``--device``
(default ``cuda``; the CPU must be asked for by name).  ``--synthetic N``
runs the pipeline on a deterministic synthetic stream.  Flags whose
machinery is not ported exit with a message.  ``--use_pallas_lbs`` keeps its
name: it selects the Hopper skinning kernel for the no-grad SMPL decodes.

Usage:
  python -m dynaboa_tpu_torch.apps.benchmark --device cuda --synthetic 8
"""

from __future__ import annotations

import argparse
import os
import os.path as osp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--expdir", type=str, default="exps")
    p.add_argument("--expname", type=str, default="3dpw")
    p.add_argument("--dataset", type=str, default="3dpw",
                   choices=["3dpw", "internet"])
    p.add_argument("--seed", type=int, default=22)
    p.add_argument("--seq_seed", type=int, default=22)
    p.add_argument("--model_file", type=str, default="data/basemodel.pt")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--save_res", type=int, default=0, choices=[0, 1])

    p.add_argument("--lr", type=float, default=3e-6)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--beta2", type=float, default=0.9)

    p.add_argument("--use_boa", type=int, default=1, choices=[0, 1])
    p.add_argument("--fastlr", type=float, default=8e-6)
    p.add_argument("--inner_step", type=int, default=1)
    p.add_argument("--record_lowerlevel", type=int, default=1)
    p.add_argument("--s2dloss_weight", type=float, default=10)
    p.add_argument("--shape_prior_weight", type=float, default=2e-6)
    p.add_argument("--pose_prior_weight", type=float, default=1e-4)

    p.add_argument("--use_frame_losses_lower", type=int, default=1)
    p.add_argument("--use_frame_losses_upper", type=int, default=1)
    p.add_argument("--use_temporal_losses_lower", type=int, default=0)
    p.add_argument("--use_temporal_losses_upper", type=int, default=1)

    p.add_argument("--sample_num", type=int, default=1)
    p.add_argument("--retrieval", type=int, default=1, choices=[0, 1])

    p.add_argument("--dynamic_boa", type=int, default=1, choices=[0, 1])
    p.add_argument("--cos_sim_threshold", type=float, default=3.1e-4)
    p.add_argument("--optim_steps", type=int, default=7)

    p.add_argument("--lower_level_mixtrain", type=int, default=1)
    p.add_argument("--upper_level_mixtrain", type=int, default=1)
    p.add_argument("--labelloss_weight", type=float, default=0.1)

    p.add_argument("--use_meanteacher", type=int, default=1, choices=[0, 1])
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--teacherloss_weight", type=float, default=0.1)

    p.add_argument("--use_motion", type=int, default=1, choices=[0, 1])
    p.add_argument("--interval", type=int, default=5)
    p.add_argument("--motionloss_weight", type=float, default=0.8)

    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic frames instead of 3DPW")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--checkpoint_duty", type=float, default=1.0 / 3.0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--parallel_streams", type=int, default=0)
    p.add_argument("--chunk_size", type=int, default=1)
    p.add_argument("--window_size", type=int, default=1)
    p.add_argument("--defer_window", type=int, default=32,
                   help="accepted for CLI parity; the port records every "
                        "frame synchronously")
    p.add_argument("--auto_reset", type=int, default=0, choices=[0, 1])
    p.add_argument("--tiny", type=int, default=0,
                   help="smoke mode: tiny network + body model")
    p.add_argument("--fused_preprocess", type=int, default=0, choices=[0, 1])
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_pallas_lbs", type=int, default=0, choices=[0, 1],
                   help="Hopper skinning kernel for the no-grad SMPL decodes")
    return p


def cfg_from_args(args):
    from dynaboa_tpu.config import AdaptConfig

    return AdaptConfig(
        lr=args.lr, beta1=args.beta1, beta2=args.beta2,
        use_boa=bool(args.use_boa), fastlr=args.fastlr,
        inner_step=args.inner_step,
        record_lowerlevel=bool(args.record_lowerlevel),
        s2dloss_weight=args.s2dloss_weight,
        shape_prior_weight=args.shape_prior_weight,
        pose_prior_weight=args.pose_prior_weight,
        use_frame_losses_lower=bool(args.use_frame_losses_lower),
        use_frame_losses_upper=bool(args.use_frame_losses_upper),
        use_temporal_losses_lower=bool(args.use_temporal_losses_lower),
        use_temporal_losses_upper=bool(args.use_temporal_losses_upper),
        retrieval=bool(args.retrieval), sample_num=args.sample_num,
        lower_level_mixtrain=bool(args.lower_level_mixtrain),
        upper_level_mixtrain=bool(args.upper_level_mixtrain),
        labelloss_weight=args.labelloss_weight,
        dynamic_boa=bool(args.dynamic_boa),
        cos_sim_threshold=args.cos_sim_threshold,
        optim_steps=args.optim_steps,
        use_meanteacher=bool(args.use_meanteacher), alpha=args.alpha,
        teacherloss_weight=args.teacherloss_weight,
        use_motion=bool(args.use_motion), interval=args.interval,
        motionloss_weight=args.motionloss_weight,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        use_pallas_lbs=bool(args.use_pallas_lbs),
    )


def _refuse_unported(args) -> None:
    unported = {
        "--chunk_size > 1": args.chunk_size != 1,
        "--window_size > 1": args.window_size != 1,
        "--fused_preprocess": args.fused_preprocess,
        "--parallel_streams": args.parallel_streams,
        "--resume": args.resume,
        "--checkpoint_every": args.checkpoint_every,
        "--auto_reset": args.auto_reset,
        "--profile_dir": args.profile_dir,
        "a real 3DPW stream (pass --synthetic N)": not args.synthetic,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise SystemExit(f"not ported to dynaboa_tpu_torch yet: "
                         f"{', '.join(bad)}")
    if args.compute_dtype != "float32":
        raise NotImplementedError(
            f"--compute_dtype {args.compute_dtype}: the PyTorch port runs "
            "float32 only")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    exppath = osp.join(args.expdir, args.expname)
    os.makedirs(exppath, exist_ok=True)

    from dynaboa_tpu.config import Paths
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import StreamRunner

    with open(osp.join(exppath, "setting.txt"), "w") as f:
        f.write("------------------ start ------------------\n")
        for k, v in sorted(vars(args).items()):
            f.write(f"{k} : {v}\n")
        f.write("------------------- end -------------------")
    cfg = cfg_from_args(args)
    paths = Paths(basemodel=args.model_file)
    tiny = dict(model_kwargs=dict(layers=(1, 1, 1, 1), width=16,
                                  regressor_dim=128),
                num_vertices=256) if args.tiny else {}
    system = build_system(cfg, paths, args.device, **tiny)
    if any(system.synthetic.values()):
        print(f"---> synthetic stand-ins active: "
              f"{[k for k, v in system.synthetic.items() if v]}")

    stream = SyntheticStream(num_frames=args.synthetic, seed=args.seq_seed)
    runner = StreamRunner(system.engine, exppath,
                          save_predictions=bool(args.save_res))
    state = system.engine.init_state(system.params, batch_size=1)
    try:
        _, summary = runner.run(stream, state,
                                keypoint_source=cfg.keypoint_source,
                                max_frames=args.max_frames)
    finally:
        runner.close()
    return summary


if __name__ == "__main__":
    main()
