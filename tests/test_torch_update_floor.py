"""The port's per-update attribution (``dynaboa_tpu_torch/tools/
profile_update_floor.py``) on the CPU at the tiny size: the JAX tool's keys,
finite times and null device fields, the FLOP counts' order, and the grad
arm's update against the engine's own gradient (bit for bit), that gradient
against the JAX engine's ``jax.value_and_grad(_level_loss)`` as the JAX
tool builds it (``tools/profile_update_floor.py:151-161``)."""

import math
import os
import re

import jax
import numpy as np
import pytest
import torch

from dynaboa_tpu.config import AdaptConfig
from dynaboa_tpu_torch.tools import profile_update_floor as puf
from tests import torch_port_fixtures as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# docs/PARITY.md: rtol ~2e-3; atol is that share of each leaf's largest entry
GRAD_RTOL = 2e-3
JAX_KEYS = ("full_step_ms_per_frame", "updates_per_frame",
            "full_step_ms_per_update", "iters", "dtype", "arms", "sum_ms",
            "grad_minus_fwd_ms")
ARM_KEYS = ("ms_per_iter", "gflop_per_iter")
DEVICE_KEYS = ("device_ms_per_iter", "kernels_per_iter", "idle_share",
               "host_syncs_per_iter", "sol_ms", "sol_share")


@pytest.fixture(scope="module")
def result():
    return puf.main(["--device", "cpu", "--tiny", "1", "--iters", "2"])


@pytest.fixture(scope="module")
def engines():
    jstore, tstore = F.singleton_stores()
    return F.build_engines(AdaptConfig(record_lowerlevel=False), jstore,
                           tstore)


def test_keys_are_the_jax_tools(result):
    src = open(os.path.join(REPO, "tools", "profile_update_floor.py")).read()
    for k in JAX_KEYS + ARM_KEYS:
        assert f'"{k}"' in src, k
    assert list(result["arms"]) == re.findall(r'run_arm\("([^"]+)"', src)
    assert set(JAX_KEYS) | {"device_sum_ms", "batched_rows"} <= set(result)
    for arm in result["arms"].values():
        assert set(ARM_KEYS + DEVICE_KEYS) <= set(arm)


def test_times_finite_and_device_fields_null_on_cpu(result):
    arms = result["arms"].values()
    times = [result["full_step_ms_per_frame"],
             result["full_step_ms_per_update"], result["sum_ms"],
             *(a["ms_per_iter"] for a in arms)]
    assert all(math.isfinite(t) and t > 0 for t in times), times
    assert math.isfinite(result["grad_minus_fwd_ms"])
    assert result["backend"] == "cpu" and result["device_sum_ms"] is None
    assert all(a[k] is None for a in arms for k in DEVICE_KEYS)
    assert result["updates_per_frame"] == 8 and result["iters"] == 2
    assert result["dtype"] == "bfloat16"


def test_flop_counts_order(result):
    g = {k: a["gflop_per_iter"] for k, a in result["arms"].items()}
    assert g[puf.GRAD] >= g[puf.FWDB] >= g[puf.FWD1] > 0
    # one forward per row: the batched forward is rows x the single one
    assert g[puf.FWDB] == pytest.approx(result["batched_rows"] * g[puf.FWD1],
                                        rel=1e-9)
    assert g[puf.ADAM] is None    # elementwise only: FlopCounterMode counts 0


def test_grad_arm_update_and_gradient_against_jax(engines):
    fr = F.make_frames(1)[0]
    tengine, jengine = engines["tengine"], engines["jengine"]

    # the port: the arm's first update against _value_and_grad's gradient
    tframe = F.torch_frame(fr)
    tstate = tengine.init_state(engines["tparams"], img_res=F.IMG)
    with torch.no_grad():
        feats = tengine._forward(tstate.params, tframe.image)[3]
    bank = tengine._retrieve(feats[5][0], torch.Generator().manual_seed(0))
    *_, g = tengine._value_and_grad(tstate.params, tframe, bank,
                                    tengine._upper, tstate.teacher_params,
                                    tengine._history(tstate))
    p0 = {k: v.detach().clone() for k, v in tstate.params.items()}
    leaves = list(tstate.params.values())
    puf.grad_body(tengine, tframe, tstate, bank)()
    assert [id(p) for p in tstate.optimizer.param_groups[0]["params"]] == \
        [id(p) for p in leaves] == [id(p) for p in tstate.params.values()]
    for (k, p), gg in zip(tstate.params.items(), g):
        assert p.is_leaf and p.requires_grad, k
        assert torch.equal(p.detach(), p0[k] - 1e-6 * gg), k

    assert any(not torch.equal(p.detach(), p0[k])
               for k, p in tstate.params.items())

    # JAX, as its tool builds the arm
    jframe = F.jax_frame(fr)
    jstate = jengine.init_state(engines["jparams"], img_res=F.IMG)
    jfeats = jax.jit(jengine._forward)(jstate.params, jframe.image)[3]
    jbank = jengine._retrieve(jfeats[5][0], jax.random.PRNGKey(0))
    np.testing.assert_array_equal(bank.images.numpy(),
                                  np.asarray(jbank.images))
    # jitted, as the JAX tool runs it (eagerly it takes over a minute on a CPU)
    _, jg = jax.jit(jax.value_and_grad(jengine._level_loss, has_aux=True),
                    static_argnums=(4,))(jstate.params, jframe, jstate, jbank,
                                         "upper", jstate.teacher_params)
    want = jax.tree.leaves(jg)
    got = jax.tree.leaves(F.port_params_as_flax(dict(zip(p0, g))))
    assert len(want) == len(got)
    for w, t in zip(want, got):
        w, t = np.asarray(w), np.asarray(t)
        np.testing.assert_allclose(t, w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max())
