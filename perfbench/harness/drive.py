"""What every entry's window needs besides the program: syncs, the
non-finite flag, the program's peak device memory apart from the check's
buffers, and the window's rate by thirds."""

from __future__ import annotations

import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nonfinite(out):
    return (~torch.isfinite(out["verts"]).all()) | \
        (~torch.isfinite(out["cam"]).all())


class PeakMemory:
    """The program's peak device memory, without the check's buffers.

    ``hold()`` and ``held()`` bracket the allocation of every buffer the
    check keeps through the run; the peak is the larger of the peak before
    them and the peak after them less their bytes."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.pre = self.base = self.bytes = 0

    def hold(self):
        if self.cuda:
            sync(self.device)
            self.pre = torch.cuda.max_memory_allocated(self.device)
            self.base = torch.cuda.memory_allocated(self.device)

    def held(self):
        if self.cuda:
            sync(self.device)
            self.bytes = torch.cuda.memory_allocated(self.device) - self.base
            torch.cuda.reset_peak_memory_stats(self.device)

    def read(self) -> int:
        if not self.cuda:
            return 0
        return int(max(self.pre, torch.cuda.max_memory_allocated(self.device)
                       - self.bytes))


def thirds(t0: float, times: list, window_s: float) -> list:
    """Frames a second in each third of the window, from the times at which
    frames completed (a diagnostic of warm-up left inside the window)."""
    third = window_s / 3
    counts = [0, 0, 0]
    for t in times:
        counts[min(int((t - t0) / third), 2)] += 1
    return [c / third for c in counts]
