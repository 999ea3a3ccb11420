"""The port stands alone: its own constants, config, GMM asset and copied
sources equal the JAX package's, and no source file of the port names the
JAX package.
(``tests/test_torch_data.py::test_port_never_imports_jax`` imports every
module of the port in a fresh interpreter and checks the same at run time.)"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from dynaboa_tpu import config as jcfg
from dynaboa_tpu import constants as jconst
from dynaboa_tpu_torch import config as tcfg
from dynaboa_tpu_torch import constants as tconst
from dynaboa_tpu_torch.losses import priors as tp
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dynaboa_tpu_torch")
CONSTANTS = sorted(n for n in vars(tconst) if n.isupper())


def test_port_constants_are_a_subset_in_use():
    assert len(CONSTANTS) >= 15
    assert set(CONSTANTS) <= {n for n in vars(jconst) if n.isupper()}


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equals_jax(name):
    t, j = getattr(tconst, name), getattr(jconst, name)
    assert type(t) is type(j)
    if isinstance(t, np.ndarray):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    else:
        assert t == j


@pytest.mark.parametrize("cls", ["AdaptConfig", "Paths"])
def test_config_fields_and_defaults_equal_jax(cls):
    t, j = getattr(tcfg, cls), getattr(jcfg, cls)
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(t)]
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(j)]
    assert tf == jf
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen


def test_config_presets_equal_jax():
    assert dataclasses.asdict(tcfg.AdaptConfig.internet()) == \
        dataclasses.asdict(jcfg.AdaptConfig.internet())
    c = tcfg.AdaptConfig().replace(lower_level_mixtrain=False,
                                   upper_level_mixtrain=False)
    assert not c.mixtrain and tcfg.AdaptConfig().mixtrain


def test_gmm_asset_is_a_byte_copy():
    path = tp.default_gmm_path()
    assert os.path.dirname(path) == os.path.join(PORT, "assets")
    with open(path, "rb") as f, open(os.path.join(
            REPO, "dynaboa_tpu", "assets", "gmm_08.npz"), "rb") as g:
        assert f.read() == g.read()


def test_port_sources_name_no_jax_package():
    pattern = re.compile(r"^\s*(?:from\s+dynaboa_tpu(?:\.\S+)?\s+import|"
                         r"import\s+dynaboa_tpu\b(?!_torch))", re.M)
    found = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    found += [(f, m) for m in pattern.findall(fh.read())]
    assert not found, found


@pytest.mark.parametrize("name", ["rasterizer.cpp", "imageops.cpp",
                                  "capture.cpp"])
def test_native_sources_are_byte_copies(name):
    with open(os.path.join(PORT, "csrc", "native", name), "rb") as f, \
            open(os.path.join(REPO, "native", name), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("port,jax_file", [
    ("data/preprocess/cdf.py", "dynaboa_tpu/data/preprocess/cdf.py"),
    ("tools/convert_smpl.py", "tools/convert_smpl.py")])
def test_python_sources_are_byte_copies(port, jax_file):
    with open(os.path.join(PORT, port), "rb") as f, \
            open(os.path.join(REPO, jax_file), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name", ["human36m.py", "video.py"])
def test_preprocess_copies_differ_only_in_imports(name):
    """Copies whose imports of the JAX package point at the port."""
    with open(os.path.join(PORT, "data", "preprocess", name)) as f, \
            open(os.path.join(REPO, "dynaboa_tpu", "data", "preprocess",
                              name)) as g:
        port, jax_src = f.read(), g.read()
    assert port != jax_src
    assert port == jax_src.replace("from dynaboa_tpu.",
                                   "from dynaboa_tpu_torch.")


def test_kmeans_is_a_copy_of_the_jax_tool():
    import inspect

    from dynaboa_tpu_torch.tools import build_retrieval as tbr
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import build_retrieval as jbr
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    assert inspect.getsource(tbr.kmeans) == inspect.getsource(jbr.kmeans)


def test_keypoint_tables_equal_jax():
    from dynaboa_tpu.ops import keypoints as jkp
    from dynaboa_tpu_torch.ops import keypoints as tkp

    assert tkp.JOINT_FORMATS == jkp.JOINT_FORMATS
    assert tkp.SKELETONS == jkp.SKELETONS
    assert tkp.POSETRACK_ORIGINAL_KP_NAMES == jkp.POSETRACK_ORIGINAL_KP_NAMES


def test_importing_builds_and_loads_nothing():
    """In a fresh interpreter where compiling or loading a shared library
    raises (once torch and numpy, which load theirs, are in), the native
    library's binding, the renderer, the capture classes and the stream app
    import, and nothing was built."""
    code = (
        "import ctypes, subprocess, numpy, torch\n"
        "def boom(*a, **k): raise AssertionError('built or loaded at import')\n"
        "subprocess.run = subprocess.Popen = ctypes.CDLL = boom\n"
        "import dynaboa_tpu_torch.native_lib as n, dynaboa_tpu_torch.viz\n"
        "import dynaboa_tpu_torch.viz.capture, dynaboa_tpu_torch.apps.stream\n"
        "import dynaboa_tpu_torch.kernels.lbs as k\n"
        "assert n._built == {} and k._built == {}\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
