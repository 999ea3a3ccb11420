"""``step.grad_idle_ms`` in the HMR 2.0 cell, which bounds the device's time per
frame (``device_ms_per_frame``): the same reading."""

import os

from perfbench.harness import found

read = found.module("metrics", "step.grad_idle_ms", os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))).read
