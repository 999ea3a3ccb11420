"""Offline data preparation (counterpart of
``dynaboa_tpu/data/preprocess``): internet-video detections, Human3.6M
frames, video frames, and the 3DPW test set (``pw3d.pw3d_extract``)."""

from dynaboa_tpu_torch.data.preprocess.internet import internet_data_extract
from dynaboa_tpu_torch.data.preprocess.human36m import h36m_train_extract
from dynaboa_tpu_torch.data.preprocess.video import video_to_images, extract_all

__all__ = ["internet_data_extract", "h36m_train_extract", "video_to_images",
           "extract_all"]
