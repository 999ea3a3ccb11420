"""Frame streams (counterpart of ``dynaboa_tpu/data/streams.py``, which
cannot be imported without jax).  Only the synthetic stream is ported: it
gives byte-identical items to ``dynaboa_tpu.data.SyntheticStream`` for the
same ``(seed, i)`` in host-preprocessed mode."""

from __future__ import annotations

import numpy as np

from dynaboa_tpu import constants


class SyntheticStream:
    """Deterministic synthetic stream with the 3DPW item schema; items are
    generated lazily per (seed, index)."""

    def __init__(self, num_frames: int = 16, img_res: int = constants.IMG_RES,
                 seed: int = 0):
        self.n = num_frames
        self.img_res = img_res
        self.seed = seed

    def _make(self, i: int) -> dict:
        r = np.random.default_rng((self.seed, i))
        return {
            "image": r.normal(size=(self.img_res, self.img_res, 3)).astype(
                np.float32),
            "smpl_j2d": np.concatenate([
                r.uniform(-1, 1, size=(49, 2)), np.ones((49, 1))], -1
            ).astype(np.float32),
            "op_j2d": np.concatenate([
                r.uniform(-1, 1, size=(49, 2)), np.ones((49, 1))], -1
            ).astype(np.float32),
            "pose": r.normal(scale=0.2, size=72).astype(np.float32),
            "betas": r.normal(scale=0.3, size=10).astype(np.float32),
            "gender": np.int32(i % 2),
            "imgname": f"synthetic_{i:06d}.png",
            "bbox": np.array([112.0, 112.0, 224.0], np.float32),
        }

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> dict:
        return self._make(i)

    def __iter__(self):
        return (self._make(i) for i in range(self.n))
