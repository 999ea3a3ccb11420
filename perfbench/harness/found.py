"""Every kind of entry the benchmark finds by name, each a file of its own
under a checkout's ``perfbench/``:

* ``metrics/<name>.py``: a metric's reader, ``read(readings, cfg)``;
* ``entries/<name>.py``: a way the window drives the program, named by a
  traffic mix's ``entry``: ``drive(run)``, ``program_side(chk)`` and
  ``reference_side(cfg, chk, device, control)``;
* ``sources/<name>.py``: a frame source, named by a mix's
  ``frames.source``: ``make(seed, spec, cfg, device)``;
* ``schedules/<name>.py``: a per-frame update-cap schedule, named by a
  mix's ``updates.caps.dist``: ``caps(spec, seed, n)``.

A later cell adds such a file beside the others and edits none.
"""

from __future__ import annotations

import importlib.util
import os

KINDS = ("metrics", "entries", "sources", "schedules")
_loaded: dict = {}


def module(kind: str, name: str, root: str):
    """The module ``<root>/perfbench/<kind>/<name>.py``."""
    if kind not in KINDS:
        raise ValueError(f"no kind {kind!r}")
    path = os.path.join(root, "perfbench", kind, f"{name}.py")
    if path not in _loaded:
        if not os.path.isfile(path):
            raise SystemExit(f"perfbench: no {kind} file {name}.py under "
                             f"{os.path.dirname(path)}")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]
