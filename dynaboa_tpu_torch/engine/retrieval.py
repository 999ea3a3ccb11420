"""Source-exemplar retrieval on the device (counterpart of
``dynaboa_tpu/engine/retrieval.py``): the pooled feature of the current
frame picks the nearest K-means centre by cosine, then a uniform draw
without replacement picks ``sample_num`` members of that cluster.  The whole
exemplar set stays on the device, so a draw needs no host sync."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ExemplarBank(NamedTuple):
    """Labeled source exemplars; images cropped to 224x224, NHWC."""

    images: torch.Tensor     # (M, 224, 224, 3)
    keypoints: torch.Tensor  # (M, 49, 3)
    pose: torch.Tensor       # (M, 72)
    betas: torch.Tensor      # (M, 10)
    pose_3d: torch.Tensor    # (M, 24, 4)

    def take(self, idx) -> "ExemplarBank":
        return ExemplarBank(*[a[idx] for a in self])


class RetrievalStore(NamedTuple):
    centers: torch.Tensor       # (C, F)
    members: torch.Tensor       # (C, maxN) int64 exemplar indices, padded
    member_mask: torch.Tensor   # (C, maxN) 1.0 where valid
    bank: ExemplarBank


def retrieve(store: RetrievalStore, feature: torch.Tensor,
             generator: torch.Generator, sample_num: int = 1) -> ExemplarBank:
    """Argmax cosine over the centres, then a Gumbel top-k draw (uniform,
    without replacement) over that cluster's valid members.

    ``generator`` lives on the store's device.  Its numbers differ from
    ``jax.random``'s (docs/PARITY.md divergence 2)."""
    f = feature / torch.clamp(torch.linalg.vector_norm(feature), min=1e-12)
    c = store.centers / torch.clamp(
        torch.linalg.vector_norm(store.centers, dim=1, keepdim=True), min=1e-12)
    cluster = torch.argmax(c @ f)
    mask = store.member_mask[cluster]
    logits = torch.where(mask > 0, 0.0, -torch.inf)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    picks = torch.topk(logits + gumbel, sample_num).indices
    return store.bank.take(store.members[cluster, picks])


def build_store(centers, cluster_indices: list[list[int]],
                bank: ExemplarBank) -> RetrievalStore:
    """Assemble the padded member matrix from per-cluster index lists, on
    the bank's device."""
    device = bank.images.device
    C = len(cluster_indices)
    maxN = max(len(ix) for ix in cluster_indices)
    members = np.zeros((C, maxN), np.int64)
    mask = np.zeros((C, maxN), np.float32)
    for c, ix in enumerate(cluster_indices):
        members[c, : len(ix)] = ix
        mask[c, : len(ix)] = 1.0
    return RetrievalStore(
        centers=torch.as_tensor(np.asarray(centers, np.float32), device=device),
        members=torch.as_tensor(members, device=device),
        member_mask=torch.as_tensor(mask, device=device),
        bank=bank)


def load_reference_store(retrieval_dir: str, source_data_path: str,
                         h36m_root: str, device) -> RetrievalStore:
    """The reference's retrieval assets: K-means centres and member lists
    (joblib, ``data/retrieval_res``) and the H36M exemplar bank they index,
    preprocessed once onto ``device``."""
    import os

    import joblib

    from dynaboa_tpu_torch.data.source import load_source_exemplars

    res = joblib.load(os.path.join(
        retrieval_dir, "cluster_res_random_sample_center_10_10_potocol2.pt"))
    centers = np.asarray(res["centers"], np.float32)
    index = res["index"]
    cluster_indices = [list(index[c]) for c in range(len(centers))]
    bank = load_source_exemplars(source_data_path, h36m_root, device)
    return build_store(centers, cluster_indices, bank)


def synthetic_store(seed: int, device, num_clusters: int = 10,
                    num_exemplars: int = 40, img_res: int = 224,
                    feat_dim: int = 2048) -> RetrievalStore:
    """Deterministic synthetic store; the same numpy recipe as the JAX
    package's, so the arrays are identical for the same arguments."""
    rng = np.random.default_rng(seed)
    M = num_exemplars

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    bank = ExemplarBank(
        images=t(rng.normal(size=(M, img_res, img_res, 3)).astype(np.float32)),
        keypoints=t(np.concatenate([
            rng.uniform(-1, 1, size=(M, 49, 2)), np.ones((M, 49, 1))], -1)),
        pose=t(rng.normal(scale=0.2, size=(M, 72)).astype(np.float32)),
        betas=t(rng.normal(scale=0.5, size=(M, 10)).astype(np.float32)),
        pose_3d=t(np.concatenate([
            rng.normal(size=(M, 24, 3)), np.ones((M, 24, 1))], -1)),
    )
    centers = rng.normal(size=(num_clusters, feat_dim)).astype(np.float32)
    per = M // num_clusters
    cluster_indices = [list(range(c * per, (c + 1) * per))
                       for c in range(num_clusters)]
    return build_store(centers, cluster_indices, bank)
