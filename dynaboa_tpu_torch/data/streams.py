"""Frame streams (counterpart of ``dynaboa_tpu/data/streams.py``, which
cannot be imported without jax).

Per-(sequence, person) npz archives of frame annotations are concatenated
into one strictly ordered frame stream.  Each item is either the 224x224
ImageNet-normalized crop (host preprocessing) or, with
``fused_preprocess=True``, the raw frame zero-padded to a static shape plus
its (center, scale), which the runner crops on the engine's device
(``ops.image.fused_crop_resize_normalize``).  Items are the same, key by
key, as the JAX package's streams give for the same files.

``cv2`` is imported only where an image is read.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from dynaboa_tpu_torch import constants
from dynaboa_tpu_torch.ops import image as I


def _imread_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1].astype(np.float32)


def _sort_key_3dpw(path: str) -> int:
    """The reference's sequence order: vid * 10 + person."""
    base = os.path.basename(path)
    vid = base.split("_")[1]
    pid = base.split("_")[2][:-4]
    return int(vid) * 10 + int(pid)


def crop_and_normalize(img: np.ndarray, center, scale) -> np.ndarray:
    """Host preprocessing: crop -> 224^2 -> [0, 1] -> ImageNet normalize,
    NHWC float32."""
    out = I.crop_numpy(img, center, scale,
                       [constants.IMG_RES, constants.IMG_RES])
    out = out.astype(np.float32) / 255.0
    return (out - constants.IMG_NORM_MEAN) / constants.IMG_NORM_STD


def pad_raw_frame(img: np.ndarray, pad_shape: tuple[int, int]) -> np.ndarray:
    """Zero-pad a raw frame to the stream's static shape.  The pad reads as
    the zeros the host crop gives outside the image, so both paths see the
    same values."""
    h, w = img.shape[:2]
    ph, pw = pad_shape
    if h > ph or w > pw:
        raise ValueError(f"frame {img.shape[:2]} exceeds pad_shape {pad_shape}")
    out = np.zeros((ph, pw, 3), img.dtype)
    out[:h, :w] = img
    return out


def _image_head(img: np.ndarray, center, scale: float, fused: bool,
                pad_shape) -> dict:
    if fused:
        return {"raw_image": pad_raw_frame(img, pad_shape).astype(np.uint8),
                "center": np.asarray(center, np.float32),
                "scale": np.float32(scale)}
    return {"image": crop_and_normalize(img, center, scale)}


def _bbox(center, scale: float) -> np.ndarray:
    return np.array([center[0], center[1], scale * 200.0], np.float32)


class PW3DStream:
    """3DPW test-set stream for the #PS protocol: the
    ``3dpw_{seq}_{person}.npz`` archives in the reference's order."""

    def __init__(self, npz_dir: str, img_root: str, prefetch: int = 8,
                 fused_preprocess: bool = False,
                 pad_shape: tuple[int, int] = (1920, 1920)):
        paths = glob.glob(osp.join(npz_dir, "3dpw_[0-9]*_[0-9].npz"))
        paths.sort(key=_sort_key_3dpw)
        if not paths:
            raise FileNotFoundError(f"no 3dpw npz archives in {npz_dir}")
        self.seq_paths = paths
        self.img_root = img_root
        self.prefetch = prefetch
        self.fused_preprocess = fused_preprocess
        self.pad_shape = pad_shape

        fields = {k: [] for k in ("imgname", "scale", "center", "pose",
                                  "shape", "j2d", "op_j2d", "gender")}
        self.seq_lengths = []
        for p in paths:
            d = np.load(p, allow_pickle=True)
            n = d["scale"].shape[0]
            self.seq_lengths.append(n)
            for k in fields:
                if k != "gender":
                    fields[k].append(d[k])
                elif "gender" in d:
                    fields[k].append(np.array(
                        [0 if str(x) == "m" else 1 for x in d["gender"]],
                        np.int32))
                else:
                    fields[k].append(-np.ones(n, np.int32))
        self.imgname = np.concatenate(fields["imgname"])
        self.scale = np.concatenate(fields["scale"]).astype(np.float32)
        self.center = np.concatenate(fields["center"]).astype(np.float32)
        self.pose = np.concatenate(fields["pose"]).astype(np.float32)
        self.betas = np.concatenate(fields["shape"]).astype(np.float32)
        self.j2d = np.concatenate(fields["j2d"]).astype(np.float32)
        self.op_j2d = np.concatenate(fields["op_j2d"]).astype(np.float32)
        self.gender = np.concatenate(fields["gender"])

    def __len__(self):
        return self.scale.shape[0]

    def record_order(self, out_path: str):
        """Write the archive order, one path per line (seq_order.record)."""
        with open(out_path, "w") as f:
            for p in self.seq_paths:
                f.write(p + "\n")

    def _load(self, i: int) -> dict:
        img = _imread_rgb(osp.join(self.img_root, str(self.imgname[i])))
        center, scale = self.center[i], float(self.scale[i])
        return _image_head(img, center, scale, self.fused_preprocess,
                           self.pad_shape) | {
            "smpl_j2d": I.normalize_j2d(self.j2d[i], center, scale),
            "op_j2d": I.normalize_j2d(self.op_j2d[i], center, scale),
            "pose": self.pose[i],
            "betas": self.betas[i],
            "gender": self.gender[i],
            "imgname": str(self.imgname[i]),
            "bbox": _bbox(center, scale),
        }

    def __getitem__(self, i: int) -> dict:
        return self._load(i)

    def __iter__(self) -> Iterator[dict]:
        return _prefetched(self._load, len(self), self.prefetch)


class InternetStream:
    """Unlabeled internet-video stream: npz archives with imgname / center /
    scale / part (49 keypoints with confidence) beside an ``images/``
    directory.  Items carry zero pose and betas and gender -1."""

    def __init__(self, root: str, prefetch: int = 8,
                 fused_preprocess: bool = False,
                 pad_shape: tuple[int, int] = (1920, 1920)):
        self.fused_preprocess = fused_preprocess
        self.pad_shape = pad_shape
        self.imgdir = osp.join(root, "images")
        paths = sorted(glob.glob(osp.join(root, "*.npz")))
        if not paths:
            raise FileNotFoundError(f"no npz archives in {root}")
        names, scales, centers, parts = [], [], [], []
        for p in paths:
            d = np.load(p, allow_pickle=True)
            names.append(d["imgname"])
            scales.append(d["scale"])
            centers.append(d["center"])
            parts.append(d["part"])
        self.imgname = np.concatenate(names)
        self.scale = np.concatenate(scales).astype(np.float32)
        self.center = np.concatenate(centers).astype(np.float32)
        self.j2d = np.concatenate(parts).astype(np.float32)
        self.prefetch = prefetch

    def __len__(self):
        return self.scale.shape[0]

    def _load(self, i: int) -> dict:
        img = _imread_rgb(osp.join(self.imgdir, str(self.imgname[i])))
        center, scale = self.center[i], float(self.scale[i])
        return _image_head(img, center, scale, self.fused_preprocess,
                           self.pad_shape) | {
            "smpl_j2d": I.normalize_j2d(self.j2d[i], center, scale),
            "pose": np.zeros(72, np.float32),
            "betas": np.zeros(10, np.float32),
            "gender": np.int32(-1),
            "imgname": str(self.imgname[i]),
            "bbox": _bbox(center, scale),
        }

    def __getitem__(self, i: int) -> dict:
        return self._load(i)

    def __iter__(self) -> Iterator[dict]:
        return _prefetched(self._load, len(self), self.prefetch)


def _prefetched(load, n: int, workers: int) -> Iterator[dict]:
    """Ordered prefetching iterator over a thread pool (the work is image
    reads and numpy crops)."""
    if workers <= 0:
        for i in range(n):
            yield load(i)
        return
    with ThreadPoolExecutor(max_workers=workers) as ex:
        window = workers * 2
        futures = {i: ex.submit(load, i) for i in range(min(window, n))}
        for i in range(n):
            item = futures.pop(i).result()
            j = i + window
            if j < n:
                futures[j] = ex.submit(load, j)
            yield item


class SyntheticStream:
    """Deterministic synthetic stream with the 3DPW item schema; items are
    generated lazily per (seed, index) and equal, byte for byte, the JAX
    package's ``SyntheticStream`` items for the same arguments.

    ``fused_preprocess=True`` emits raw uint8 frames (2x the crop
    resolution, smooth 8x8 blocks) with (center, scale) instead of
    host-cropped images."""

    def __init__(self, num_frames: int = 16, img_res: int = constants.IMG_RES,
                 seed: int = 0, fused_preprocess: bool = False):
        self.n = num_frames
        self.img_res = img_res
        self.seed = seed
        self.fused_preprocess = fused_preprocess

    def _make_raw(self, r) -> dict:
        raw_res = self.img_res * 2
        low = r.integers(0, 256, size=(raw_res // 8, raw_res // 8, 3))
        raw = np.kron(low, np.ones((8, 8, 1))).astype(np.uint8)
        center = np.asarray([raw_res / 2.0, raw_res / 2.0], np.float32)
        scale = np.float32(self.img_res * 1.1 / 200.0)
        return {"raw_image": raw, "center": center, "scale": scale,
                "out_res": self.img_res}

    def _make(self, i: int) -> dict:
        r = np.random.default_rng((self.seed, i))
        if self.fused_preprocess:
            head = self._make_raw(r)
        else:
            head = {"image": r.normal(
                size=(self.img_res, self.img_res, 3)).astype(np.float32)}
        return head | {
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
