"""Small constant tensors made once per device and reused.

A tensor built from Python data on a card (``torch.tensor([...],
device="cuda")``, or advanced indexing with a Python list) is a pageable
host-to-device copy that blocks the host until the card has caught up, and
that a CUDA graph cannot capture.  The index lists and constant rows that
the SMPL decode, the priors and the camera use inside the gradient come
from here instead: built once per (values, dtype, device), then reused.
"""

from __future__ import annotations

import torch

_CONSTS: dict = {}


def device_const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The constant ``torch.tensor(values, dtype=dtype, device=device)``,
    built on the first call for these arguments.  ``values`` is a number or
    a (nested) tuple of numbers; callers must not write to the result."""
    key = (values, dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
