"""``group_norm_roofline.engine``: its counts from the configurations (the
GroupNorm elements of one HMR image row, the image rows a frame
normalises), its reading on a synthetic trace, and None where the trace
holds no such kernel (a program without it)."""

from __future__ import annotations

import json
import os

import pytest

from perfbench.harness import found, work

import tiny

ROOT = tiny.ROOT
NAME = "group_norm_roofline.engine"


def _cfg(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _reader():
    return found.module("metrics", NAME, ROOT)


def test_elements_per_row_at_the_3dpw_widths():
    m = _reader()
    assert m.elements_per_row(_cfg("dynaboa_3dpw")["model"]) == 11_113_984
    assert m.elements_per_row(_cfg("dynaboa_webcam")["model"]) == 11_113_984


@pytest.mark.parametrize("n", range(1, 9))
def test_rows_per_frame(n):
    """The initial forward, the lower gradient's frame and exemplar rows,
    the lower record, and per update three gradient rows (frame, history,
    exemplar), the teacher and the gate: 4 + 5 n in 3DPW; the webcam's has
    no exemplar or lower record: 2 + 4 n."""
    m = _reader()
    assert m.rows_per_frame(_cfg("dynaboa_3dpw")["adapt"], n) == 4 + 5 * n
    assert m.rows_per_frame(_cfg("dynaboa_webcam")["adapt"], n) == 2 + 4 * n


def test_reading_on_a_synthetic_trace():
    cfg = _cfg("dynaboa_3dpw")
    updates = [1, 8, 1, 7, 2, 4, 2, 4]          # the traced segment's caps
    launches = 53 * sum(3 + 3 * n for n in updates)
    assert launches == 5883
    r = {"trace": {"updates": updates, "kernels": {
        "void (anonymous namespace)::dynaboa_group_norm_fwd(const float*)":
            [4e-6] * launches,
        "void at::native::RowwiseMomentsCUDAKernel<float>": [1.0]}}}
    rows = sum(4 + 5 * n for n in updates)
    assert rows == 177
    least = 8 * 11_113_984 * rows / work.PEAK_HBM_BYTES
    assert _reader().read(r, cfg) == pytest.approx(
        100 * least / (4e-6 * launches), rel=1e-12)


@pytest.mark.parametrize("trace", [
    None, {}, {"updates": [1, 2], "kernels": {}},
    {"updates": [1, 2], "kernels": {
        "void at::native::RowwiseMomentsCUDAKernel<float>": [1e-5],
        "void lbs_skin_kernel<32>": [1e-5]}}])
def test_none_without_the_kernel(trace):
    r = {} if trace is None else {"trace": trace}
    assert _reader().read(r, _cfg("dynaboa_3dpw")) is None


def test_listed_for_the_3dpw_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    m = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert len(m) == 1 and m[0]["workloads"] == ["pw3d.geo_updates"]
    assert m[0]["moves"] == "device_ms_per_frame"
    assert m[0]["layer"] == "kernels" and m[0]["unit"] == "%"
