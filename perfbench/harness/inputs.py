"""The inputs both sides are given, made from ``--seed`` on the device:
the HMR weights, the SMPL bodies, the H36M regressor, the retrieval store,
and the GMM prior's raw arrays (a frozen copy of the shipped prior).

Each is drawn with a ``torch.Generator`` on the device, in a few large
calls, in float32, and each kind from a generator of its own so that one
kind's sizes do not move another kind's numbers.  The licensed files
(``basemodel.pt``, SMPL, the H36M exemplar bank) are not in the repository,
so these stand in for them; the configurations list them under
``assumed``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

GMM_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "reference", "gmm_08.npz")
NPOSE = 144
# SMPL's vertex ids of the 21 joints taken from the mesh (SPIN's selector)
VERTEX_JOINT_IDS = (332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624,
                    6787, 2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905,
                    6016, 6133)
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                17, 18, 19, 20, 21)
# streams of the seed: one generator per kind of input
WEIGHTS, BODIES, STORE, FRAMES = range(4)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + stream) % (2 ** 63))
    return g


def hmr_shapes(model: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init kind) of every HMR parameter, in the checkpoint's
    order; kinds: conv, gn_w, gn_b, lin (PyTorch's default Linear draw),
    head (xavier-uniform with gain 0.01, bias 0)."""
    w, R = model["width"], model["regressor_dim"]
    out = [("conv1.weight", (w, 3, 7, 7), "conv"),
           ("bn1.weight", (w,), "gn_w"), ("bn1.bias", (w,), "gn_b")]
    inplanes = w
    for li, (mult, blocks) in enumerate(zip((1, 2, 4, 8), model["layers"]), 1):
        planes = w * mult
        for b in range(blocks):
            pre = f"layer{li}.{b}"
            cin = inplanes if b == 0 else planes * 4
            for i, (co, ci, k) in enumerate(((planes, cin, 1),
                                             (planes, planes, 3),
                                             (planes * 4, planes, 1)), 1):
                out += [(f"{pre}.conv{i}.weight", (co, ci, k, k), "conv"),
                        (f"{pre}.bn{i}.weight", (co,), "gn_w"),
                        (f"{pre}.bn{i}.bias", (co,), "gn_b")]
            if b == 0:
                out += [(f"{pre}.downsample.0.weight", (planes * 4, cin, 1, 1),
                         "conv"),
                        (f"{pre}.downsample.1.weight", (planes * 4,), "gn_w"),
                        (f"{pre}.downsample.1.bias", (planes * 4,), "gn_b")]
        inplanes = planes * 4
    feat = inplanes
    for name, fi, fo, kind in (("fc1", feat + NPOSE + 13, R, "lin"),
                               ("fc2", R, R, "lin"),
                               ("decpose", R, NPOSE, "head"),
                               ("decshape", R, 10, "head"),
                               ("deccam", R, 3, "head")):
        out += [(f"{name}.weight", (fo, fi), kind),
                (f"{name}.bias", (fo,), kind + "_b")]
    return out


def hmr_weights(model: dict, seed: int, device) -> dict:
    """Seeded HMR weights: convolutions normal(0, sqrt(2 / (k k out))),
    GroupNorm (1, 0), fc1 / fc2 uniform(+-1 / sqrt(fan_in)), the decoder
    heads xavier-uniform with gain 0.01 and zero bias.  One normal and one
    uniform draw for the whole network."""
    shapes = hmr_shapes(model)
    g = generator(seed, WEIGHTS, device)
    n_normal = sum(math.prod(s) for _, s, k in shapes if k == "conv")
    n_unif = sum(math.prod(s) for _, s, k in shapes
                 if k in ("lin", "lin_b", "head"))
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device) * 2.0 - 1.0
    out, i, j = {}, 0, 0
    fan = {}
    for name, shape, kind in shapes:
        n = math.prod(shape)
        if kind == "conv":
            std = math.sqrt(2.0 / (shape[2] * shape[3] * shape[0]))
            out[name] = (normal[i:i + n] * std).reshape(shape)
            i += n
        elif kind == "gn_w":
            out[name] = torch.ones(shape, device=device)
        elif kind in ("gn_b", "head_b"):
            out[name] = torch.zeros(shape, device=device)
        else:
            if kind == "head":
                fo, fi = shape
                bound = 0.01 * math.sqrt(6.0 / (fi + fo))
            elif kind == "lin":
                fan[name.split(".")[0]] = shape[1]
                bound = 1.0 / math.sqrt(shape[1])
            else:
                bound = 1.0 / math.sqrt(fan[name.split(".")[0]])
            out[name] = (unif[j:j + n] * bound).reshape(shape)
            j += n
    return out


def mean_params(device) -> tuple:
    """The regressor's starting point: every joint at the identity rotation
    (6D (1, 0, 0, 1, 0, 0)), zero shape, camera (0.9, 0, 0)."""
    pose = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0],
                        device=device).repeat(24)[None]
    return (pose, torch.zeros((1, 10), device=device),
            torch.tensor([[0.9, 0.0, 0.0]], device=device))


def smpl_body(g: torch.Generator, smpl: dict, device) -> dict:
    """One seeded body of the published sizes: a kinematic tree of 24
    joints, each vertex owned by a joint and skinned mostly to it, shape and
    pose blend shapes, a regressor that averages each joint's vertices, 9
    extra joints of 4 vertices each, and faces that join neighbouring
    vertices of one body part."""
    V, K, nb = smpl["num_vertices"], smpl["num_joints"], smpl["num_betas"]
    F = smpl["num_faces"]
    steps = torch.randn((K, 3), generator=g, device=device)
    joints = [steps[0] * 0.3]
    for k in range(1, K):
        joints.append(joints[SMPL_PARENTS[k]] + steps[k] * 0.15)
    joints = torch.stack(joints)
    owner = torch.randint(0, K, (V,), generator=g, device=device)
    v_template = joints[owner] + 0.07 * torch.randn(
        (V, 3), generator=g, device=device)
    d2 = ((v_template[:, None] - joints[None]) ** 2).sum(-1)
    w = torch.exp(-d2 / 0.02) + torch.nn.functional.one_hot(owner, K)
    onehot = torch.nn.functional.one_hot(owner, K).to(torch.float32).T
    extra_cols = torch.randint(0, V, (9, 4), generator=g, device=device)
    J_extra = torch.zeros((9, V), device=device)
    J_extra.scatter_(1, extra_cols, 0.25)
    # neighbours in (part, height) order make a body part's faces
    order = torch.argsort(owner * 16 + torch.clamp(
        (v_template[:, 1] + 2.0) * 3.0, 0, 15).long())
    idx = torch.arange(F, device=device) % (V - 3)
    step = (torch.arange(F, device=device) >= V - 3).long()
    faces = torch.stack([order[idx], order[idx + 1 + step], order[idx + 2 + step]],
                        1)
    return {
        "v_template": v_template,
        "shapedirs": 0.01 * torch.randn((V, 3, nb), generator=g, device=device),
        "posedirs": 0.001 * torch.randn(((K - 1) * 9, V * 3), generator=g,
                                        device=device),
        "J_regressor": onehot / onehot.sum(1, keepdim=True).clamp(min=1.0),
        "lbs_weights": w / w.sum(1, keepdim=True),
        "J_regressor_extra": J_extra,
        "vertex_joint_ids": torch.tensor(
            [min(i, V - 1) for i in VERTEX_JOINT_IDS], device=device),
        "parents": SMPL_PARENTS,
        "faces": faces.to(torch.int32).cpu().numpy(),
    }


def bodies(smpl: dict, seed: int, device) -> tuple[dict, torch.Tensor]:
    """Neutral, male and female bodies, and the H36M joint regressor
    (17 rows, each a Dirichlet(1) draw over the vertices)."""
    g = generator(seed, BODIES, device)
    out = {k: smpl_body(g, smpl, device) for k in ("neutral", "male",
                                                    "female")}
    e = -torch.log(torch.rand((17, smpl["num_vertices"]), generator=g,
                              device=device))
    return out, e / e.sum(1, keepdim=True)


def store(spec: dict, feat_dim: int, img_res: int, seed: int, device) -> dict:
    """A retrieval store of ``clusters`` x ``per_cluster`` labeled exemplars
    at ``img_res``: images, 49 keypoints with confidence 1, pose, shape,
    24 3D joints with visibility 1, and the cluster centres."""
    g = generator(seed, STORE, device)
    C, per = spec["clusters"], spec["per_cluster"]
    M = C * per

    def n(*s, scale=1.0):
        return scale * torch.randn(s, generator=g, device=device)

    ones = torch.ones
    return {
        "images": n(M, img_res, img_res, 3),
        "keypoints": torch.cat([torch.rand((M, 49, 2), generator=g,
                                           device=device) * 2 - 1,
                                ones((M, 49, 1), device=device)], -1),
        "pose": n(M, 72, scale=0.2),
        "betas": n(M, 10, scale=0.5),
        "pose_3d": torch.cat([n(M, 24, 3), ones((M, 24, 1), device=device)],
                             -1),
        "centers": n(C, feat_dim),
        "members": torch.arange(M, device=device).reshape(C, per),
        "member_mask": ones((C, per), device=device),
    }


def gmm_arrays() -> dict:
    """The shipped 8-component GMM pose prior: means, covars, weights."""
    with np.load(GMM_FILE) as d:
        return {k: d[k] for k in ("means", "covars", "weights")}
