"""Named spans of the program's phases in the trace of ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
session records, so a phase sits on the clock of the kernels, copies and
syncs it launched; otherwise it is one shared no-op context.  The check
comes first because an idle ``record_function`` still costs about twenty
times as much as the check and the no-op together.

Only the thread that opened the profiler, and threads started before it
did, reach the trace: a span opened on a thread started inside the profiled
region does not.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` as a span while a profiler session
    records, and does nothing otherwise."""
    return torch.profiler.record_function(name) if _recording() else _OFF
