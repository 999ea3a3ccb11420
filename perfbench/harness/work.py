"""The work a frame needs by the protocol, counted from the configuration's
shapes: the FLOPs of the HMR forwards and backwards a frame takes, and the
bytes one launch of the skinning kernel has to move.  The counts read the
configuration only, never the implementation, so a program that skips work
is still held to the protocol's total.

Peaks are the NVIDIA H100 SXM data sheet's (dense, no sparsity, 700 W).
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12       # float32 outside the tensor cores (TF32 off)
PEAK_HBM_BYTES = 3.35e12
POSE_FEATS = 207
NPOSE = 144


def _conv(cin, cout, k, hw_out):
    return cin * cout * k * k * hw_out * hw_out


def hmr_forward_flops(model: dict) -> int:
    """FLOPs (2 per multiply-add) of the convolutions and linear layers of
    one HMR forward of one image row: ResNet-50 with stride on the 3x3
    convolution and a downsample in every stage's first block, then
    ``n_iter`` regressor iterations.  Normalisation, activations and
    pooling are not counted."""
    w, R, res = model["width"], model["regressor_dim"], model["img_res"]
    s = (res + 2 * 3 - 7) // 2 + 1          # conv1, stride 2, pad 3
    macs = _conv(3, w, 7, s)
    s = (s + 2 - 3) // 2 + 1                # max pool 3, stride 2, pad 1
    inplanes = w
    for li, (mult, blocks) in enumerate(zip((1, 2, 4, 8), model["layers"])):
        planes = w * mult
        for b in range(blocks):
            stride = 2 if (b == 0 and li > 0) else 1
            s_out = (s + 2 - 3) // stride + 1
            cin = inplanes if b == 0 else planes * 4
            macs += _conv(cin, planes, 1, s)
            macs += _conv(planes, planes, 3, s_out)
            macs += _conv(planes, planes * 4, 1, s_out)
            if b == 0:
                macs += _conv(cin, planes * 4, 1, s_out)
            s = s_out
        inplanes = planes * 4
    macs += model["n_iter"] * ((inplanes + NPOSE + 13) * R + R * R
                               + R * (NPOSE + 10 + 3))
    return 2 * macs


def rows_per_frame(adapt: dict, n_updates: int) -> int:
    """Forward-row equivalents of one frame with ``n_updates`` outer updates
    (a backward counted as two forwards): the initial forward; the lower
    gradient over the frame and, where they are on, the history row and
    the exemplars; the lower record's forward; per update the upper
    gradient over its rows, the teacher forward and the gate's forward."""
    sample = adapt["sample_num"]

    def rows(level):
        temporal = adapt[f"use_temporal_losses_{level}"]
        mixtrain = adapt[f"{level}_level_mixtrain"]
        return (1 + (1 if temporal and adapt["use_motion"] else 0)
                + (sample if mixtrain else 0))

    def teacher(level):
        return 1 if (adapt[f"use_temporal_losses_{level}"]
                     and adapt["use_meanteacher"]) else 0

    total = 1
    total += adapt["inner_step"] * (3 * rows("lower") + teacher("lower")
                                    + (1 if adapt["record_lowerlevel"] else 0))
    total += n_updates * (3 * rows("upper") + teacher("upper") + 1)
    return total


def frame_flops(model: dict, adapt: dict, n_updates: int) -> int:
    return rows_per_frame(adapt, n_updates) * hmr_forward_flops(model)


def skin_bytes(n: int, num_vertices: int, num_joints: int = 24) -> int:
    """Bytes one skinning launch must move at batch ``n``: posedirs and the
    weights read once, the shaped vertices read and the vertices written,
    the pose features and the joint transforms read."""
    V = num_vertices
    return 4 * (POSE_FEATS * 3 * V + num_joints * V + n * 2 * 3 * V
                + n * (POSE_FEATS + num_joints * 16))


def skin_least_seconds(n: int, num_vertices: int) -> float:
    return skin_bytes(n, num_vertices) / PEAK_HBM_BYTES
