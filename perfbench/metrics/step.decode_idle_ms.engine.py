"""``step.decode_idle_ms`` in the cells that bound the device's time per frame
(``device_ms_per_frame``) in place of the rate: the same reading."""

import os

from perfbench.harness import found

read = found.module("metrics", "step.decode_idle_ms", os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))).read
