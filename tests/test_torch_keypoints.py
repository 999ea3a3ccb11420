"""The port's keypoint tables and converters (``ops/keypoints.py``) and the
offline internet-video extraction (``data/preprocess/internet.py``) against
the JAX package's on the same inputs: every output must be equal exactly."""

import itertools
import json

import numpy as np
import pytest

from dynaboa_tpu.data.preprocess import internet as jinternet
from dynaboa_tpu.ops import keypoints as jkp
from dynaboa_tpu_torch.data.preprocess import internet as tinternet
from dynaboa_tpu_torch.ops import keypoints as tkp

FORMATS = sorted(jkp.JOINT_FORMATS)
PAIRS = list(itertools.product(FORMATS, FORMATS))


def test_every_format_and_pair_is_covered():
    assert len(FORMATS) == 15 and len(PAIRS) == 225
    assert sorted(tkp.JOINT_FORMATS) == FORMATS


def test_tables_equal_jax():
    assert tkp.JOINT_FORMATS == jkp.JOINT_FORMATS
    assert tkp.SKELETONS == jkp.SKELETONS
    assert tkp.POSETRACK_ORIGINAL_KP_NAMES == jkp.POSETRACK_ORIGINAL_KP_NAMES


@pytest.mark.parametrize("src,dst", PAIRS)
def test_conversion_equals_jax(src, dst):
    assert tkp.get_perm_idxs(src, dst) == jkp.get_perm_idxs(src, dst)
    tg, tm = tkp.conversion_table(src, dst)
    jg, jm = jkp.conversion_table(src, dst)
    for a, b in ((tg, jg), (tm, jm)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    joints = np.random.default_rng(len(src) * 31 + len(dst)).normal(
        size=(2, len(jkp.JOINT_FORMATS[src]), 3)).astype(np.float32)
    t, j = tkp.convert_kps(joints, src, dst), jkp.convert_kps(joints, src, dst)
    assert t.dtype == j.dtype and t.shape == (2, len(tkp.joint_names(dst)), 3)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("fmt", sorted(jkp.SKELETONS))
def test_skeleton_equals_jax(fmt):
    t, j = tkp.get_skeleton(fmt), jkp.get_skeleton(fmt)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


def test_hflip_and_unknown_format_equal_jax():
    kp = np.random.default_rng(0).uniform(0, 100, size=(4, 17, 3))
    np.testing.assert_array_equal(tkp.keypoint_hflip(kp, 100.0),
                                  jkp.keypoint_hflip(kp, 100.0))
    for mod in (tkp, jkp):
        with pytest.raises(ValueError, match="unknown skeleton format"):
            mod.get_perm_idxs("nope", "coco")
        with pytest.raises(ValueError, match="no skeleton table"):
            mod.get_skeleton("h36m")


def _alphapose_json(path, seq: str, seed: int):
    """Detections of a few frames: kept ones, a low-score one, a small
    person and one with low-confidence joints."""
    rng = np.random.default_rng(seed)
    annots = []
    for i in range(6):
        kp = np.concatenate([rng.uniform(50, 450, size=(17, 2)),
                             rng.uniform(0, 1, size=(17, 1))], -1)
        if i == 2:
            kp[:, :2] = rng.uniform(100, 150, size=(17, 2))   # too small
        annots.append({"image_id": f"{i:05d}.jpg",
                       "score": 1.0 if i == 4 else 2.5 + i,
                       "keypoints": kp.ravel().round(3).tolist()})
    (path / f"{seq}.json").write_text(json.dumps(annots))


def test_internet_extract_equals_jax(tmp_path):
    outs = {}
    for name, mod in (("j", jinternet), ("t", tinternet)):
        d = tmp_path / name
        d.mkdir()
        _alphapose_json(d, "clip_a", 0)
        _alphapose_json(d, "clip_b", 1)
        mod.internet_data_extract(str(d))
        outs[name] = {s: dict(np.load(d / f"{s}.npz"))
                      for s in ("clip_a", "clip_b")}
    for seq in ("clip_a", "clip_b"):
        t, j = outs["t"][seq], outs["j"][seq]
        assert t.keys() == j.keys() == {"imgname", "center", "scale", "part"}
        for k in t:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert 0 < len(t["imgname"]) < 6       # some detections filtered
        assert t["part"].shape[1:] == (49, 3)


def test_bbox_and_height_equal_jax():
    kp = np.random.default_rng(2).uniform(0, 300, size=(25, 3))
    assert tinternet.person_height(kp) == jinternet.person_height(kp)
    for sf in (1.0, 1.2):
        assert tinternet.bbox_from_kp(kp, sf) == jinternet.bbox_from_kp(kp, sf)
    kp[:, 2] = 0.0
    assert tinternet.person_height(kp) == jinternet.person_height(kp) == 0.0
