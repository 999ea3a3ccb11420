#!/usr/bin/env python
"""Offline data-preparation dispatcher (counterpart of
``dynaboa_tpu/apps/process_data.py``).

Usage:
  python -m dynaboa_tpu_torch.apps.process_data --dataset internet
  python -m dynaboa_tpu_torch.apps.process_data --dataset h36m
  python -m dynaboa_tpu_torch.apps.process_data --dataset 3dpw [--device cpu]
  python -m dynaboa_tpu_torch.apps.process_data --dataset video

The roots come from ``Paths`` (``PW3D_ROOT``, ``H36M_ROOT``,
``INTERNET_ROOT``, ``SMPL_MODEL_DIR``); 3DPW archives go to
``data/dataset_extras`` under the working directory.  ``--device`` places
the 3DPW branch's SMPL models; it defaults to ``cuda`` and raises without a
CUDA device.
"""

from __future__ import annotations

import argparse

from dynaboa_tpu_torch.config import Paths


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True,
                        choices=["3dpw", "3dhp", "h36m", "internet", "video"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the 3DPW branch's SMPL decodes")
    args = parser.parse_args(argv)
    paths = Paths()

    if args.dataset == "h36m":
        from dynaboa_tpu_torch.data.preprocess import h36m_train_extract

        h36m_train_extract(paths.h36m_root, training_split=False,
                           extract_img=False)
    elif args.dataset == "internet":
        from dynaboa_tpu_torch.data.preprocess import internet_data_extract

        internet_data_extract(paths.internet_root)
    elif args.dataset == "video":
        from dynaboa_tpu_torch.data.preprocess import extract_all

        extract_all(paths.internet_root)
    elif args.dataset == "3dpw":
        import os

        from dynaboa_tpu_torch.apps.common import require_device
        from dynaboa_tpu_torch.data.preprocess.pw3d import pw3d_extract
        from dynaboa_tpu_torch.models.smpl import load_smpl_npz

        device = require_device(args.device)
        male = load_smpl_npz(os.path.join(paths.smpl_model_dir,
                                          "smpl_male.npz"), device)
        female = load_smpl_npz(os.path.join(paths.smpl_model_dir,
                                            "smpl_female.npz"), device)
        pw3d_extract(paths.pw3d_root, paths.dataset_npz_path, male, female)
    else:
        print("Not implemented.")


if __name__ == "__main__":
    main()
