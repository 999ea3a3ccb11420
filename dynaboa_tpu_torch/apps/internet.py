#!/usr/bin/env python
"""Internet-video streaming adaptation on PyTorch (no ground truth; the
counterpart of ``dynaboa_tpu/apps/internet.py``).

The benchmark CLI's flags, with the internet preset (``--dataset
internet``, ``--expname internet``, ``--shape_prior_weight 2e-4``).  Metrics
are not computed; every frame's prediction is written to
``<expdir>/<expname>/result/Pred_<i>.npz`` (verts, cam translation,
crop-space cam, rotmat, betas), and with ``--save_res 1`` its overlay to
``image/Pred_<i>.png`` and its mesh to ``mesh/Pred_<i>.obj``.  The stream
is ``InternetStream`` over ``Paths.internet_root``, or a synthetic one
under ``--synthetic N``.

Usage:
  python -m dynaboa_tpu_torch.apps.internet --device cuda --expdir exps
  python -m dynaboa_tpu_torch.apps.internet --device cpu --tiny 1 --synthetic 4
"""

from __future__ import annotations

import os
import os.path as osp

from dynaboa_tpu_torch.apps.benchmark import (build_parser, cfg_from_args,
                                              refuse_unported, run_stream,
                                              tiny_kwargs)


def main(argv=None):
    parser = build_parser()
    parser.set_defaults(dataset="internet", expname="internet",
                        shape_prior_weight=2e-4)
    args = parser.parse_args(argv)
    refuse_unported(args)
    exppath = osp.join(args.expdir, args.expname)
    os.makedirs(exppath, exist_ok=True)

    from dynaboa_tpu_torch.config import Paths
    from dynaboa_tpu_torch.apps.common import build_system, write_settings
    from dynaboa_tpu_torch.data.streams import InternetStream, SyntheticStream

    write_settings(exppath, args)
    cfg = cfg_from_args(args)
    paths = Paths(basemodel=args.model_file)
    fused = bool(args.fused_preprocess)
    if args.synthetic:
        stream = SyntheticStream(num_frames=args.synthetic, seed=args.seq_seed,
                                 fused_preprocess=fused)
    else:
        stream = InternetStream(paths.internet_root, fused_preprocess=fused)
    # unlabeled stream: metrics are undefined, the predictions are the output
    system = build_system(cfg, paths, args.device, compute_metrics=False,
                          **tiny_kwargs(args))
    # InternetStream's imgnames are relative to its images/ directory
    return run_stream(system, stream, args, exppath, save_predictions=True,
                      img_root=osp.join(paths.internet_root, "images"))


if __name__ == "__main__":
    main()
