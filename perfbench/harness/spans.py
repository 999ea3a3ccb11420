"""Device idle time put down to the phases of ``BilevelEngine.step``.

The program opens a span for each phase of its step (``engine.step`` around
the call, ``step.*`` inside it); ``trace.reduce`` names each idle gap of
the device after the innermost host operation or span running on the main
thread at the gap's midpoint (``idle_by_host_op``).  A phase's reading is
the idle time so labelled with its spans, in ms per ``step`` call.  A gap
inside a phase whose innermost operation is an ATen call keeps that call's
name and is not read here.
"""

from __future__ import annotations

STEP = "engine.step"
PHASE = "step."


def has_phase_spans(idle: dict) -> bool:
    """Whether the trace holds the program's step spans at all."""
    return any(k == STEP or k.startswith(PHASE) for k in idle)


def idle_ms(r: dict, names: tuple = (), prefixes: tuple = ()):
    """Idle ms per ``step`` call labelled with one of ``names`` or a name
    starting with one of ``prefixes``; ``None`` without a trace, without a
    ``step`` call, or where the program has no step spans (a version of it
    before them)."""
    t = r.get("trace")
    if not t or not t.get("step_calls"):
        return None
    idle = t["idle_by_host_op"]
    if not has_phase_spans(idle):
        return None
    s = sum(v for k, v in idle.items()
            if k in names or k.startswith(prefixes))
    return 1000.0 * s / t["step_calls"]
