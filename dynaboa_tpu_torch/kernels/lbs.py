"""SMPL skinning through the hand-written Hopper kernel ``csrc/lbs_skin.cu``.

It replaces the Pallas kernel ``dynaboa_tpu/kernels/lbs.py:_skin_kernel``
(launched by ``skinning_kernel_call``, wrapped by ``PallasSMPL``): the
pose-blendshape contraction and the linear blend skinning of every vertex,
in one pass over posedirs.

What bounds it on the H100: at N=1 it reads posedirs once (207*6890*3*4 B =
17.1 MB) and the skinning weights (0.66 MB) and does about 8.6 MFLOP, so it
is memory- and latency-bound; the HBM floor is about 5 us at the H100 SXM's
data-sheet 3.35 TB/s (700 W part; derived, not measured).  The source note in
``csrc/lbs_skin.cu`` says what the design does about that; measured times
are in the root PERF.md.

``LBSKernelSMPL(model)(betas, rotmats)`` has the contract of the JAX
``PallasSMPL``: the shape blendshapes, rest joints and kinematic chain stay
torch ops (the same ops as the eager ``lbs``, so the posed joints are
bit-identical to it), and the kernel writes the (N, V, 3) vertices.  It has
no backward pass and serves only decodes outside gradient computations.

``skin`` dispatches on the device of its inputs: CPU tensors take the plain
PyTorch version ``skin_plain``; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from dynaboa_tpu_torch.models.smpl import (SMPLModel, _rigid_transform_chain,
                                           pose_features,
                                           shaped_vertices_and_joints)

NUM_JOINTS = 24
POSE_FEATS = 207

_built = {}     # the loaded library, built at the first CUDA launch


def library():
    """Build (at first use) and load the kernel's shared library."""
    if "lbs_skin" not in _built:
        from dynaboa_tpu_torch.kernels.build import build

        b = build("lbs_skin")
        fn = b.lib.lbs_skin_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _built["lbs_skin"] = b
    return _built["lbs_skin"]


def skin_plain(pose_feature, posedirs_k, v_shaped, weights_k, rel):
    """Plain PyTorch version of the kernel, same arguments as ``skin``."""
    offsets = torch.einsum("np,pcv->nvc", pose_feature, posedirs_k)
    v_posed = v_shaped + offsets
    T = torch.einsum("kv,nkij->nvij", weights_k, rel[:, :, :3])   # (N,V,3,4)
    return (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]


def _check(pose_feature, posedirs_k, v_shaped, weights_k, rel):
    args = dict(pose_feature=pose_feature, posedirs_k=posedirs_k,
                v_shaped=v_shaped, weights_k=weights_k, rel=rel)
    for name, t in args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"skin: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"skin: {name} must be contiguous")
        if t.device != pose_feature.device:
            raise ValueError(f"skin: {name} is on {t.device}, pose_feature "
                             f"on {pose_feature.device}")
    N, V = v_shaped.shape[0], v_shaped.shape[1]
    want = dict(pose_feature=(N, POSE_FEATS), posedirs_k=(POSE_FEATS, 3, V),
                v_shaped=(N, V, 3), weights_k=(NUM_JOINTS, V),
                rel=(N, NUM_JOINTS, 4, 4))
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"skin: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args.values()):
        raise RuntimeError("skin has no backward pass: call it under "
                           "torch.no_grad() or use the eager smpl lbs")


def skin(pose_feature, posedirs_k, v_shaped, weights_k, rel):
    """Pose blendshapes + linear blend skinning -> (N, V, 3).

    Args:
      pose_feature: (N, 207)
      posedirs_k: (207, 3, V) kernel layout (``LBSKernelSMPL.posedirs_k``)
      v_shaped: (N, V, 3) shaped template vertices
      weights_k: (24, V) joint-major skinning weights
      rel: (N, 24, 4, 4) relative joint transforms
    """
    _check(pose_feature, posedirs_k, v_shaped, weights_k, rel)
    dev = pose_feature.device
    if dev.type == "cpu":
        return skin_plain(pose_feature, posedirs_k, v_shaped, weights_k, rel)
    if dev.type != "cuda":
        raise ValueError(f"skin: no kernel for device {dev}")
    N, V = v_shaped.shape[0], v_shaped.shape[1]
    out = torch.empty((N, V, 3), dtype=torch.float32, device=dev)
    err = library().lib.lbs_skin_forward(
        pose_feature.data_ptr(), posedirs_k.data_ptr(), v_shaped.data_ptr(),
        weights_k.data_ptr(), rel.data_ptr(), out.data_ptr(), N, V,
        POSE_FEATS, NUM_JOINTS, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lbs_skin kernel launch failed with CUDA error "
                           f"{err}")
    skin.launches += 1
    return out


skin.launches = 0   # kernel launches (CUDA path only)


class LBSKernelSMPL:
    """SMPL forward whose skinning runs in the Hopper kernel.

    Holds kernel-layout copies of the model buffers: posedirs (207, 3, V),
    so neighbouring threads read neighbouring vertices, and joint-major
    weights (24, V).
    """

    def __init__(self, model: SMPLModel):
        self.model = model
        V = model.v_template.shape[0]
        self.posedirs_k = model.posedirs.reshape(POSE_FEATS, V, 3).permute(
            0, 2, 1).contiguous()
        self.weights_k = model.lbs_weights.t().contiguous()

    def __call__(self, betas: torch.Tensor, rotmats: torch.Tensor):
        """betas (N, 10), rotmats (N, 24, 3, 3) -> vertices (N, V, 3),
        posed kinematic joints (N, 24, 3)."""
        v_shaped, J = shaped_vertices_and_joints(self.model, betas)
        posed_joints, rel = _rigid_transform_chain(rotmats, J,
                                                   self.model.parents)
        verts = skin(pose_features(rotmats), self.posedirs_k,
                     v_shaped.contiguous(), self.weights_k, rel.contiguous())
        return verts, posed_joints
