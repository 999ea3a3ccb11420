"""SMPL skinning through the hand-written Hopper kernel ``csrc/lbs_skin.cu``.

It replaces the Pallas kernel ``dynaboa_tpu/kernels/lbs.py:_skin_kernel``
(launched by ``skinning_kernel_call``, wrapped by ``PallasSMPL``): the
pose-blendshape contraction and the linear blend skinning of every vertex,
in one pass over posedirs.

What bounds it on the H100: it must read posedirs (207*3*6890*4 B =
17.1 MB) and the skinning weights (0.66 MB) once per call, whatever N, and
does about 12.5 MFLOP per sample, so it is memory-bound: 17.94 MB at N = 1
is 5.36 us at the H100 SXM's data-sheet 3.35 TB/s (derived, not measured).
The source note in ``csrc/lbs_skin.cu`` says what the design does about
that; measured times are in the root PERF.md.

The kernel reads the model's buffers in a tile-major layout built once by
``LBSKernelSMPL``: V padded to a multiple of the tile T (32 vertices by
default), posedirs as (V/T, 207, 3, T) and the weights as (V/T, 24, T), so
that each tile is one contiguous block that a bulk copy can fetch.
``to_tiles`` builds it, ``from_tiles`` undoes it; the plain version takes
the same layout.

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
TILE = 32              # vertices per tile, one CTA each (216 at V = 6890)
TILES = (32, 64)       # the tiles the kernel is built for
WARPS = 8              # warps per CTA

_built = {}     # the loaded library, built at the first CUDA launch


def library():
    """Build (at first use) and load the kernel's shared library."""
    if "lbs_skin" not in _built:
        from dynaboa_tpu_torch.kernels.build import build

        b = build("lbs_skin")
        fn = b.lib.lbs_skin_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        b.lib.lbs_skin_smem_bytes.argtypes = [ctypes.c_int]
        b.lib.lbs_skin_smem_bytes.restype = ctypes.c_int
        b.lib.lbs_skin_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        b.lib.lbs_skin_blocks_per_sm.restype = ctypes.c_int
        _built["lbs_skin"] = b
    return _built["lbs_skin"]


def to_tiles(a: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """(..., V) -> (ceil(V / tile), ..., tile): the kernel's tile-major
    layout, zero-padded to whole tiles and contiguous."""
    V = a.shape[-1]
    n_tiles = -(-V // tile)
    a = torch.nn.functional.pad(a, (0, n_tiles * tile - V))
    return a.reshape(*a.shape[:-1], n_tiles, tile).movedim(-2, 0).contiguous()


def from_tiles(a: torch.Tensor, V: int) -> torch.Tensor:
    """Inverse of ``to_tiles``: (n_tiles, ..., tile) -> (..., V)."""
    return a.movedim(0, -2).flatten(-2)[..., :V]


def skin_plain(pose_feature, posedirs_t, v_shaped, weights_t, rel):
    """Plain PyTorch version of the kernel, same arguments as ``skin``."""
    V = v_shaped.shape[1]
    offsets = torch.einsum("np,pcv->nvc", pose_feature,
                           from_tiles(posedirs_t, V))
    v_posed = v_shaped + offsets
    T = torch.einsum("kv,nkij->nvij", from_tiles(weights_t, V),
                     rel[:, :, :3])                               # (N,V,3,4)
    return (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]


def _check(pose_feature, posedirs_t, v_shaped, weights_t, rel):
    args = dict(pose_feature=pose_feature, posedirs_t=posedirs_t,
                v_shaped=v_shaped, weights_t=weights_t, rel=rel)
    for name, t in args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"skin: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"skin: {name} must be contiguous")
        if t.device != pose_feature.device:
            raise ValueError(f"skin: {name} is on {t.device}, pose_feature "
                             f"on {pose_feature.device}")
    N, V = v_shaped.shape[0], v_shaped.shape[1]
    tile = posedirs_t.shape[-1]
    if tile not in TILES:
        raise ValueError(f"skin: posedirs_t has tile {tile}, expected one "
                         f"of {TILES}")
    n_tiles = -(-V // tile)
    want = dict(pose_feature=(N, POSE_FEATS),
                posedirs_t=(n_tiles, POSE_FEATS, 3, tile),
                v_shaped=(N, V, 3), weights_t=(n_tiles, NUM_JOINTS, tile),
                rel=(N, NUM_JOINTS, 4, 4))
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"skin: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args.values()):
        raise RuntimeError("skin has no backward pass: call it under "
                           "torch.no_grad() or use the eager smpl lbs")


def skin(pose_feature, posedirs_t, v_shaped, weights_t, rel, warps=WARPS):
    """Pose blendshapes + linear blend skinning -> (N, V, 3).

    Args:
      pose_feature: (N, 207)
      posedirs_t: (V/T, 207, 3, T) tile-major posedirs (``to_tiles``)
      v_shaped: (N, V, 3) shaped template vertices
      weights_t: (V/T, 24, T) tile-major skinning weights
      rel: (N, 24, 4, 4) relative joint transforms
      warps: warps per CTA of the kernel (1..8)
    """
    _check(pose_feature, posedirs_t, v_shaped, weights_t, rel)
    dev = pose_feature.device
    if dev.type == "cpu":
        return skin_plain(pose_feature, posedirs_t, v_shaped, weights_t, rel)
    if dev.type != "cuda":
        raise ValueError(f"skin: no kernel for device {dev}")
    if posedirs_t.data_ptr() % 16 or weights_t.data_ptr() % 16:
        raise ValueError("skin: posedirs_t and weights_t must be 16-byte "
                         "aligned for the bulk copies")
    N, V = v_shaped.shape[0], v_shaped.shape[1]
    out = torch.empty((N, V, 3), dtype=torch.float32, device=dev)
    err = library().lib.lbs_skin_forward(
        pose_feature.data_ptr(), posedirs_t.data_ptr(), v_shaped.data_ptr(),
        weights_t.data_ptr(), rel.data_ptr(), out.data_ptr(), N, V,
        POSE_FEATS, NUM_JOINTS, posedirs_t.shape[-1], warps, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lbs_skin kernel launch failed with CUDA error "
                           f"{err}")
    skin.launches += 1
    return out


skin.launches = 0   # kernel launches (CUDA path only)


class LBSKernelSMPL:
    """SMPL forward whose skinning runs in the Hopper kernel.

    Holds tile-major copies of the model buffers, built once: posedirs
    (V/T, 207, 3, T) and weights (V/T, 24, T), V padded to whole tiles.
    """

    def __init__(self, model: SMPLModel, tile: int = TILE):
        self.model = model
        V = model.v_template.shape[0]
        self.posedirs_t = to_tiles(model.posedirs.reshape(
            POSE_FEATS, V, 3).permute(0, 2, 1), tile)
        self.weights_t = to_tiles(model.lbs_weights.t(), tile)

    def __call__(self, betas: torch.Tensor, rotmats: torch.Tensor):
        """betas (N, 10), rotmats (N, 24, 3, 3) -> vertices (N, V, 3),
        posed kinematic joints (N, 24, 3)."""
        v_shaped, J = shaped_vertices_and_joints(self.model, betas)
        posed_joints, rel = _rigid_transform_chain(rotmats, J,
                                                   self.model.parents)
        verts = skin(pose_features(rotmats), self.posedirs_t,
                     v_shaped.contiguous(), self.weights_t, rel.contiguous())
        return verts, posed_joints
