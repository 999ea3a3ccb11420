"""``device.idle_share`` in the CLIFF cell, which bounds the device's time
per frame (``device_ms_per_frame``): the same reading."""

import os

from perfbench.harness import found

read = found.module("metrics", "device.idle_share", os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))).read
