"""The port's crop geometry and fused preprocessing against the JAX
package's ``ops/image.py``: the host (numpy) part equal within 1e-6, the
fused on-device crop in float32 within 1e-5 on normalized pixels, and the
fused crop against the host crop within docs/PARITY.md divergence 3."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynaboa_tpu import constants
from dynaboa_tpu.data import SyntheticStream as JStream
from dynaboa_tpu.ops import image as JI
from dynaboa_tpu_torch.ops import image as TI
from tests import torch_port_fixtures  # noqa: F401  (shares the cores)

FUSED_ATOL = 1e-5
HOST_ATOL = 1e-6
# docs/PARITY.md divergence 3: fused supersampled box filter vs the host
# gaussian prefilter
DIV3_MAX = 5e-2
DIV3_MEAN = 5e-3

# (center, scale) over a 96x80 frame: inside, across each border, a
# downsampling box and an upsampling one
CROPS = [((48.0, 40.0), 0.30), ((10.5, 12.0), 0.25), ((90.0, 75.5), 0.35),
         ((48.0, 40.0), 0.60), ((30.2, 61.7), 0.12)]


def _frame(seed=0, h=80, w=96):
    # smooth content (8x8 blocks) as the synthetic raw stream has
    r = np.random.default_rng(seed)
    low = r.integers(0, 256, size=(h // 8, w // 8, 3))
    return np.kron(low, np.ones((8, 8, 1))).astype(np.uint8)


@pytest.mark.parametrize("center,scale", CROPS)
def test_host_geometry_matches_jax(center, scale):
    res = [constants.IMG_RES, constants.IMG_RES]
    np.testing.assert_array_equal(TI.get_transform(center, scale, res, 12.0),
                                  JI.get_transform(center, scale, res, 12.0))
    for a, b in zip(TI.crop_bounds(center, scale, res),
                    JI.crop_bounds(center, scale, res)):
        np.testing.assert_array_equal(a, b)
    kp = np.concatenate([np.random.default_rng(1).uniform(
        0, 90, size=(49, 2)), np.ones((49, 1))], -1).astype(np.float32)
    np.testing.assert_array_equal(TI.normalize_j2d(kp, center, scale),
                                  JI.normalize_j2d(kp, center, scale))


@pytest.mark.parametrize("center,scale", CROPS[:3])
def test_host_crop_matches_jax(center, scale):
    img = _frame().astype(np.float32)
    np.testing.assert_allclose(TI.crop_numpy(img, center, scale, [24, 24]),
                               JI.crop_numpy(img, center, scale, [24, 24]),
                               rtol=0, atol=HOST_ATOL)
    np.testing.assert_allclose(TI.resize_bilinear_np(img, (30, 20)),
                               JI.resize_bilinear_np(img, (30, 20)),
                               rtol=0, atol=HOST_ATOL)


@pytest.mark.parametrize("center,scale", CROPS)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_fused_matches_jax(center, scale, dtype):
    img = _frame(2).astype(dtype)
    want = np.asarray(JI.fused_crop_resize_normalize(
        jnp.asarray(img, jnp.float32), jnp.asarray(center, jnp.float32),
        jnp.float32(scale), out_res=24))
    got = TI.fused_crop_resize_normalize(
        torch.as_tensor(img), torch.tensor(center), torch.tensor(scale),
        out_res=24)
    assert got.dtype == torch.float32 and got.shape == (24, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FUSED_ATOL)


def test_fused_matches_jax_on_the_synthetic_raw_frame():
    item = JStream(1, img_res=32, seed=7, fused_preprocess=True)[0]
    want = np.asarray(JI.fused_crop_resize_normalize(
        jnp.asarray(item["raw_image"], jnp.float32),
        jnp.asarray(item["center"]), jnp.asarray(item["scale"]), out_res=32))
    got = TI.fused_crop_resize_normalize(
        torch.as_tensor(item["raw_image"]), torch.as_tensor(item["center"]),
        torch.as_tensor(item["scale"]), out_res=32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FUSED_ATOL)
    # the host crop of the same frame (gaussian prefilter against the 2x
    # supersampled box filter): the JAX runner test's mean bound
    host = TI.crop_numpy(item["raw_image"].astype(np.float32),
                         item["center"], float(item["scale"]), [32, 32])
    host = (host.astype(np.float32) / 255.0 - constants.IMG_NORM_MEAN) \
        / constants.IMG_NORM_STD
    assert np.abs(got - host).mean() < DIV3_MAX


# the second box crosses the frame's bottom-right corner.  Only boxes whose
# corners the two paths truncate alike are comparable: the host path takes
# them through a float64 inverse matrix, the fused one as trunc(c -/+ h/2)
@pytest.mark.parametrize("center,scale", [((320.0, 240.0), 1.1),
                                          ((620.0, 460.0), 0.8)])
def test_fused_within_divergence_3_of_the_host_crop(center, scale):
    """Without the prefilters (host anti_aliasing off, supersample 1) both
    paths are the same bilinear crop: docs/PARITY.md divergence 3 bounds
    them per normalized pixel.  (center, scale) are float32 on both paths,
    as the streams give them: the box corners truncate the same way."""
    img = np.random.default_rng(3).uniform(0, 255, size=(480, 640, 3)
                                           ).astype(np.float32)
    center, scale = np.asarray(center, np.float32), np.float32(scale)
    ul, br = TI.crop_bounds(center, scale, [224, 224])
    h = np.float32(200.0) * scale
    np.testing.assert_array_equal(ul, np.trunc(center - h / 2))
    np.testing.assert_array_equal(br, np.trunc(center + h / 2))
    host = TI.crop_numpy(img, center, scale, [224, 224], anti_aliasing=False)
    host = (host.astype(np.float32) / 255.0 - constants.IMG_NORM_MEAN) \
        / constants.IMG_NORM_STD
    dev = TI.fused_crop_resize_normalize(
        torch.as_tensor(img), torch.as_tensor(center), torch.tensor(scale),
        supersample=1).numpy()
    diff = np.abs(dev - host)
    assert diff.max() < DIV3_MAX and diff.mean() < DIV3_MEAN, \
        (diff.max(), diff.mean())
