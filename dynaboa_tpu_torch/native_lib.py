"""ctypes binding to the port's copy of the native host library
(``csrc/native/*.cpp``, byte copies of the JAX package's ``native/``; the
counterpart of ``dynaboa_tpu/native_lib.py``).

Components:
  * rasterizer — weak-perspective mesh renderer (replaces pyrender/EGL)
  * imageops   — fused crop/resize/normalize host preprocessing
  * capture    — tick-published frame ring buffer (replaces the reference's
                 unsynchronized capture thread)

The library is built with the host C++ compiler and ``native/Makefile``'s
flags (less OpenMP, see ``kernels/build.py``) into ``_build/`` at the first
call that needs it, never at import (``kernels.build.build_host``).  A
failed build raises: there is no quiet fallback.  A caller that wants the
numpy rasterizer asks ``viz.renderer.Renderer`` for it by name.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dynaboa_tpu_torch import constants
from dynaboa_tpu_torch.ops.image import crop_bounds

SOURCES = ("native/rasterizer.cpp", "native/imageops.cpp",
           "native/capture.cpp")

_built = {}     # the loaded library, built at first use


def library():
    """Build (at first use) and load the native library; returns the
    ``kernels.build.BuiltLibrary``."""
    if "native" not in _built:
        from dynaboa_tpu_torch.kernels.build import build_host

        b = build_host("dynaboa_native", list(SOURCES))
        lib = b.lib
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.render_mesh.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int,
                                    f32p, ctypes.c_int, ctypes.c_int, f32p,
                                    u8p, ctypes.c_int]
        lib.render_mesh.restype = ctypes.c_int
        lib.composite_over.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int]
        lib.composite_over.restype = ctypes.c_int
        lib.crop_resize_normalize.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p]
        lib.crop_resize_normalize.restype = ctypes.c_int
        lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_destroy.restype = None
        lib.ring_push.argtypes = [ctypes.c_void_p, u8p]
        lib.ring_push.restype = ctypes.c_uint64
        lib.ring_read_latest.argtypes = [ctypes.c_void_p, u8p]
        lib.ring_read_latest.restype = ctypes.c_uint64
        lib.ring_latest_tick.argtypes = [ctypes.c_void_p]
        lib.ring_latest_tick.restype = ctypes.c_uint64
        _built["native"] = b
    return _built["native"]


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def render_mesh(verts: np.ndarray, faces: np.ndarray, cam, width: int,
                height: int, color=(1.0, 1.0, 0.9),
                cull: bool = False) -> np.ndarray:
    """Rasterize (verts, faces) under the weak-perspective cam
    (sx, sy, tx, ty) -> (H, W, 4) uint8 RGBA.  ``cull`` skips camera-averted
    faces: sound for closed outward-CCW meshes (SMPL), and halves the raster
    work; leave it False for arbitrary open meshes."""
    lib = library().lib
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    cam = np.ascontiguousarray(cam, np.float32)
    color = np.ascontiguousarray(color, np.float32)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or \
            faces.shape[1] != 3 or cam.shape != (4,) or color.shape != (3,):
        raise ValueError(f"render_mesh: verts {verts.shape}, faces "
                         f"{faces.shape}, cam {cam.shape}, color "
                         f"{color.shape}; expected (V, 3), (F, 3), (4,), (3,)")
    out = np.zeros((height, width, 4), np.uint8)
    rc = lib.render_mesh(_fp(verts), verts.shape[0], _i32(faces),
                         faces.shape[0], _fp(cam), width, height,
                         _fp(color), _u8(out), int(cull))
    if rc != 0:
        raise RuntimeError(f"render_mesh returned {rc}")
    return out


def composite_over(rgba: np.ndarray, img: np.ndarray) -> np.ndarray:
    """Write the covered pixels of ``rgba`` (H, W, 4) over ``img`` (H, W, 3
    uint8); returns ``img`` (a contiguous uint8 copy when it was not one)."""
    lib = library().lib
    img = np.ascontiguousarray(img, np.uint8)
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.shape != img.shape[:2] + (4,) or img.shape[2:] != (3,):
        raise ValueError(f"composite_over: rgba {rgba.shape}, img "
                         f"{img.shape}")
    lib.composite_over(_u8(rgba), _u8(img), img.shape[1], img.shape[0])
    return img


def crop_resize_normalize(img: np.ndarray, center, scale: float,
                          out_res: int = 224, supersample: int = 1,
                          mean=None, std=None) -> np.ndarray:
    """Crop (H, W, 3) float RGB in [0, 255] by (center, scale), resize to
    ``out_res`` and ImageNet-normalize, on the host."""
    lib = library().lib
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"crop_resize_normalize: image {img.shape}, "
                         f"expected (H, W, 3)")
    mean = np.ascontiguousarray(
        constants.IMG_NORM_MEAN if mean is None else mean, np.float32)
    std = np.ascontiguousarray(
        constants.IMG_NORM_STD if std is None else std, np.float32)
    out = np.empty((out_res, out_res, 3), np.float32)
    # the exact integer box comes from the host implementation of the crop
    ul, br = crop_bounds(center, scale, [out_res, out_res])
    rc = lib.crop_resize_normalize(
        _fp(img), img.shape[0], img.shape[1],
        int(ul[0]), int(ul[1]), int(br[0]), int(br[1]),
        out_res, supersample, _fp(mean), _fp(std), _fp(out))
    if rc != 0:
        raise RuntimeError(f"crop_resize_normalize returned {rc}")
    return out


class FrameRing:
    """Tick-published single-producer single-consumer frame ring (native;
    see ``csrc/native/capture.cpp``).  ``close`` frees it."""

    def __init__(self, slots: int, frame_shape: tuple[int, ...]):
        self._lib = library().lib
        self.frame_shape = tuple(frame_shape)
        self._bytes = int(np.prod(frame_shape))
        self._h = self._lib.ring_create(slots, self._bytes)

    def push(self, frame: np.ndarray) -> int:
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.nbytes != self._bytes:
            raise ValueError(f"frame of {frame.nbytes} B pushed into a ring "
                             f"of {self.frame_shape} frames")
        return int(self._lib.ring_push(self._h, _u8(frame)))

    def read_latest(self) -> tuple[int, np.ndarray | None]:
        out = np.empty(self.frame_shape, np.uint8)
        t = int(self._lib.ring_read_latest(self._h, _u8(out)))
        return (t, out) if t else (0, None)

    def latest_tick(self) -> int:
        return int(self._lib.ring_latest_tick(self._h))

    def close(self):
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
