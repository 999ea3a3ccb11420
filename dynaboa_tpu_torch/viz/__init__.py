"""Visualization and capture: the mesh renderer and the live frame and
keypoint sources.  Importing builds nothing: the native library is built at
the first call that needs it."""

from dynaboa_tpu_torch.viz.renderer import (
    Renderer,
    convert_crop_cam_to_orig_img,
    render_overlay,
)

__all__ = ["Renderer", "convert_crop_cam_to_orig_img", "render_overlay"]
