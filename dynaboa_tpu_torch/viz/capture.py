"""Frame capture and 2D keypoint providers for the live stream path
(counterpart of ``dynaboa_tpu/viz/capture.py``).

Capability parity with reference ``utils/webcam_utils.py``: a threaded camera
reader (WebcamVideoStream:15-49) and the OpenPose BODY_25 wrapper
(OpenposeWarper:52-68).  The reference's capture thread hands out
``self.frame`` unlocked (a benign-but-real data race, SURVEY §5); here frames
go through the native tick-published ring buffer (``native_lib.FrameRing``)
so the consumer always sees a fully written frame and can detect drops.

``cv2`` and the OpenPose bindings are imported only by the classes that use
them.
"""

from __future__ import annotations

import threading
from typing import Protocol

import numpy as np

from dynaboa_tpu_torch import native_lib


class FrameSource:
    """Threaded capture into a tear-free latest-frame ring.

    Works for webcams (device index) and video files (path).  ``read()``
    returns (tick, frame) where tick increases monotonically per captured
    frame: the reference's latest-frame-wins policy, minus the torn reads.
    ``stop()`` ends the capture thread and frees the ring.
    """

    def __init__(self, src=0, ring_slots: int = 4):
        import cv2

        self._cap = cv2.VideoCapture(src)
        if not self._cap.isOpened():
            raise RuntimeError(f"cannot open capture source {src!r}")
        ok, frame = self._cap.read()
        if not ok:
            self._cap.release()
            raise RuntimeError(f"capture source {src!r} produced no frames")
        self.frame_shape = frame.shape
        self._ring = native_lib.FrameRing(ring_slots, frame.shape)
        self._ring.push(frame)
        self._stopped = False
        self._ended = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stopped:
            ok, frame = self._cap.read()
            if not ok:
                self._ended = True
                return
            self._ring.push(frame)

    def read(self) -> tuple[int, np.ndarray | None]:
        return self._ring.read_latest()

    @property
    def ended(self) -> bool:
        return self._ended

    def stop(self):
        self._stopped = True
        self._thread.join(timeout=2)
        self._cap.release()
        if not self._thread.is_alive():
            self._ring.close()


class KeypointProvider(Protocol):
    """BODY_25 keypoints for one BGR frame: returns (1, 25, 3) or None when
    no person is detected."""

    def estimate(self, frame_bgr: np.ndarray) -> np.ndarray | None: ...


class OpenPoseProvider:
    """Live OpenPose BODY_25 wrapper (reference webcam_utils.py:52-68);
    requires the user-installed OpenPose python bindings."""

    def __init__(self, model_folder: str, net_resolution: str = "-1x368"):
        from openpose import pyopenpose as op  # type: ignore

        self._op = op
        self._wrapper = op.WrapperPython()
        self._wrapper.configure({"model_folder": model_folder,
                                 "net_resolution": net_resolution})
        self._wrapper.start()

    def estimate(self, frame_bgr: np.ndarray) -> np.ndarray | None:
        datum = self._op.Datum()
        datum.cvInputData = frame_bgr
        self._wrapper.emplaceAndPop(self._op.VectorDatum([datum]))
        kp = datum.poseKeypoints
        if kp is None or len(kp) == 0:
            return None
        return np.asarray(kp[:1], np.float32)  # first person


class PrecomputedKeypoints:
    """Keypoints from an npz produced offline (AlphaPose/OpenPose), keyed by
    frame index: lets the stream app run without native pose bindings."""

    def __init__(self, path: str):
        d = np.load(path, allow_pickle=True)
        self._kp = np.asarray(d["keypoints"], np.float32)  # (N, 25, 3)
        self._i = 0

    def estimate(self, frame_bgr: np.ndarray) -> np.ndarray | None:
        if self._i >= self._kp.shape[0]:
            return None
        kp = self._kp[self._i]
        self._i += 1
        if (kp[:, 2] > 0).sum() < 3:
            return None
        return kp[None]
