#!/usr/bin/env python
"""Convert official SMPL body-model pickles to the framework's .npz format.

The SMPL body data is license-gated (https://smpl.is.tue.mpg.de) and is NOT
redistributed with this repo; users supply their own copy, exactly as with
the reference (reference README.md setup steps; config.py SMPL_MODEL_DIR).

Usage:
  python tools/convert_smpl.py --model-dir data/smpl --out-dir data/smpl_npz \
      [--extra-regressor data/J_regressor_extra.npy]

Reads SMPL_{NEUTRAL,MALE,FEMALE}.pkl (chumpy-flavoured pickles) and writes
smpl_{neutral,male,female}.npz with plain float32 arrays:
  v_template (6890,3), shapedirs (6890,3,10), posedirs (207, 20670),
  J_regressor (24,6890), weights (6890,24), kintree_parents (24,),
  f (13776,3), J_regressor_extra (9,6890) if provided.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _to_np(x) -> np.ndarray:
    """Undo chumpy / scipy-sparse wrappers without importing chumpy."""
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    if hasattr(x, "r"):  # chumpy array
        return np.asarray(x.r)
    return np.asarray(x)


class _ChumpyUnpickler(pickle.Unpickler):
    """Load SMPL pickles without chumpy installed: map chumpy arrays to a
    minimal shim exposing `.r`."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            class _Ch:  # minimal stand-in; pickle fills __dict__
                @property
                def r(self):
                    return self.__dict__.get("x")
            return _Ch
        return super().find_class(module, name)


def convert_one(pkl_path: str, out_path: str, extra_regressor: str | None):
    with open(pkl_path, "rb") as f:
        data = _ChumpyUnpickler(f, encoding="latin1").load()

    posedirs = _to_np(data["posedirs"]).astype(np.float32)  # (6890, 3, 207)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T   # (207, 20670)

    out = dict(
        v_template=_to_np(data["v_template"]).astype(np.float32),
        shapedirs=_to_np(data["shapedirs"])[..., :10].astype(np.float32),
        posedirs=posedirs,
        J_regressor=_to_np(data["J_regressor"]).astype(np.float32),
        weights=_to_np(data["weights"]).astype(np.float32),
        kintree_parents=np.asarray(data["kintree_table"])[0].astype(np.int32),
        f=_to_np(data["f"]).astype(np.int32),
    )
    out["kintree_parents"][0] = -1
    if extra_regressor and os.path.exists(extra_regressor):
        out["J_regressor_extra"] = np.load(extra_regressor).astype(np.float32)
    np.savez_compressed(out_path, **out)
    print(f"wrote {out_path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--extra-regressor", default=None)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    names = {
        "SMPL_NEUTRAL.pkl": "smpl_neutral.npz",
        "SMPL_MALE.pkl": "smpl_male.npz",
        "SMPL_FEMALE.pkl": "smpl_female.npz",
        # SPIN-style naming fallbacks
        "basicmodel_neutral_lbs_10_207_0_v1.0.0.pkl": "smpl_neutral.npz",
        "basicmodel_m_lbs_10_207_0_v1.0.0.pkl": "smpl_male.npz",
        "basicmodel_f_lbs_10_207_0_v1.0.0.pkl": "smpl_female.npz",
    }
    done = set()
    for src, dst in names.items():
        p = os.path.join(args.model_dir, src)
        if os.path.exists(p) and dst not in done:
            convert_one(p, os.path.join(args.out_dir, dst),
                        args.extra_regressor)
            done.add(dst)
    if not done:
        raise SystemExit(f"no SMPL pickles found in {args.model_dir}")


if __name__ == "__main__":
    main()
