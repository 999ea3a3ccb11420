#!/usr/bin/env python
"""Build the source-exemplar retrieval store from scratch (counterpart of
the JAX package's ``tools/build_retrieval.py``).

Runs the base model over every exemplar crop, pools the 2048-d feature
(tap 5), k-means clusters it, and writes an npz with ``centers``,
``assignments`` and ``feats``.

Usage:
  python -m dynaboa_tpu_torch.tools.build_retrieval \
      --source data/retrieval_res/h36m_... --h36m-root /data/h36m \
      --out data/retrieval_res/clusters.npz [--clusters 10] [--device cpu]

``--device`` defaults to ``cuda`` and raises without a CUDA device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

FEATURE_BATCH = 8


def kmeans(feats: np.ndarray, k: int, iters: int = 50, seed: int = 0):
    """Numpy k-means over cosine-normalized features with k-means++ seeding
    (uniform seeding can drop a true cluster when two seeds land in one)."""
    rng = np.random.default_rng(seed)
    f = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    # k-means++: each next seed drawn proportional to cosine distance from
    # the nearest already-chosen seed
    seeds = [rng.integers(len(f))]
    for _ in range(1, k):
        d = np.min(1.0 - f @ f[seeds].T, axis=1)
        d = np.maximum(d, 0.0)
        p = d / d.sum() if d.sum() > 0 else None
        seeds.append(int(rng.choice(len(f), p=p)))
    centers = f[seeds].copy()
    assign = np.zeros(len(f), np.int64)
    for _ in range(iters):
        sims = f @ centers.T
        new_assign = sims.argmax(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            members = f[assign == c]
            if len(members):
                centers[c] = members.mean(0)
                centers[c] /= max(np.linalg.norm(centers[c]), 1e-12)
    return centers, assign


def features_and_clusters(images: torch.Tensor, model, k: int,
                          batch: int = FEATURE_BATCH):
    """Tap-5 features of ``images`` (M, H, W, 3), NHWC on the model's
    device, in batches of ``batch`` under ``torch.no_grad()``, and their
    k-means clusters.  Returns (centers (k, D), assignments (M,), feats
    (M, D)) as numpy."""
    model.eval()
    with torch.no_grad():
        feats = np.concatenate([
            model(images[i:i + batch].permute(0, 3, 1, 2))[3][5].cpu().numpy()
            for i in range(0, images.shape[0], batch)
        ])
    centers, assign = kmeans(feats, k)
    return centers, assign, feats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True,
                    help="joblib/npz source-exemplar archive")
    ap.add_argument("--h36m-root", required=True)
    ap.add_argument("--basemodel", default="data/basemodel.pt")
    ap.add_argument("--out", required=True)
    ap.add_argument("--clusters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dynaboa_tpu_torch.apps.common import require_device
    from dynaboa_tpu_torch.data.source import load_source_exemplars
    from dynaboa_tpu_torch.models.hmr import load_basemodel

    device = require_device(args.device)
    bank = load_source_exemplars(args.source, args.h36m_root, device)
    model = load_basemodel(args.basemodel, device)
    centers, assign, feats = features_and_clusters(bank.images, model,
                                                   args.clusters)
    np.savez(args.out, centers=centers, assignments=assign, feats=feats)
    sizes = np.bincount(assign, minlength=args.clusters)
    print(f"wrote {args.out}: {args.clusters} clusters, sizes {sizes}")


if __name__ == "__main__":
    main()
