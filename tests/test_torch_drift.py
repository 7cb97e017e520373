"""Where the BatchNorm statistics' drift after ten VQA steps comes from: the
port's fp32 trajectory and the JAX package's fp32 trajectory (CE, the
setting of tests/test_torch_finetune.py's ``run`` fixture) each held
against a third, the JAX step under ``jax_enable_x64`` with float64
parameters, statistics, optimizer state and compute (the JAX package's own
float32 casts inside, in SERF, the softmax and the loss, stay). The port is
no farther from that reference than the JAX package's fp32 run, and the
two fp32 runs sit on either side of it: the 2.4e-4 between them in
``stage4_block0/bn1/mean`` is fp32 rounding grown over ten steps, not a
fault of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train.state import TrainState as JaxTrainState

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.data.images import AugmentSpec
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_vqa_steps

from test_torch_finetune import (
    CRITERIA,
    LR,
    N_STEPS,
    NOOP,
    STATS_DRIFT,
    _flat,
    _recording_tx,
    _tiny,
    _variables,
    _vqa_batch,
)

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

DRIFTING = "batch_stats/trans/trunk/stage4_block0/bn1/mean"
MLM_PIN = 2e-4  # tests/test_torch_train.py's trajectory atol for statistics


def _jax_trajectory(jcfg, variables, batches, x64: bool):
    """N_STEPS steps of the JAX train step; float64 throughout under x64."""
    dtype = np.float64 if x64 else np.float32
    jax.config.update("jax_enable_x64", x64)
    try:
        cast = lambda a: jnp.asarray(np.asarray(a, dtype))  # noqa: E731
        params = jax.tree.map(cast, variables["params"])
        tx = _recording_tx(LR)
        state = JaxTrainState(
            step=jnp.asarray(0, jnp.int32), params=params,
            batch_stats=jax.tree.map(cast, variables["batch_stats"]),
            opt_state=jax.jit(tx.init)(params), tx=tx)
        step, _ = jax_steps.make_vqa_steps(
            JaxMMBert(jcfg, dtype=jnp.dtype(dtype)), jcfg,
            aug=JaxAugmentSpec(**NOOP))
        key, losses = jax.random.PRNGKey(3), []
        for i in range(N_STEPS):
            b = {k: jnp.asarray(v.astype(dtype) if v.dtype == np.float32
                                else v) for k, v in batches[i % 3].items()}
            key, sub = jax.random.split(key)
            state, m = step(state, b, sub)
            losses.append(float(m["loss"]))
        tree = _flat(jax.device_get({"params": state.params,
                                     "batch_stats": state.batch_stats}))
        assert tree[DRIFTING].dtype == dtype
        return {k: v.astype(np.float64) for k, v in tree.items()}, losses
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def trajectories():
    cfg, jcfg = _tiny(**CRITERIA["ce"])
    rng = np.random.default_rng(31)
    batches = [_vqa_batch(cfg, rng) for _ in range(3)]
    variables = _variables(jcfg)
    out = {"jax32": _jax_trajectory(jcfg, variables, batches, False),
           "x64": _jax_trajectory(jcfg, variables, batches, True)}
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    state = create_train_state(model, LR)
    step, _ = make_vqa_steps(model, cfg, aug=AugmentSpec(**NOOP))
    losses = []
    for i in range(N_STEPS):
        state, m = step(state, batches[i % 3])
        losses.append(float(m["loss"]))
    tree = _flat(bridge.to_flax(model.state_dict(), model))
    out["port32"] = ({k: v.astype(np.float64) for k, v in tree.items()},
                     losses)
    return out


def _dist(a, b, keys):
    return np.array([np.abs(a[k] - b[k]).max() for k in keys])


def test_the_drifting_statistic_is_fp32_noise(trajectories):
    """In the statistic F7 names, the port's fp32 run is no farther from the
    float64 run than the JAX package's fp32 run (1.74e-4 against 1.81e-4 in
    the run that set this test), the two fp32 runs lie farther apart than
    either lies from it (2.38e-4: they err on opposite sides), and the JAX
    package's own fp32 run sits at over half the MLM pin from it: the pin
    bounds one run's rounding, not the gap between two."""
    ref = trajectories["x64"][0]
    jax32, port32 = trajectories["jax32"][0], trajectories["port32"][0]
    d_jax = np.abs(jax32[DRIFTING] - ref[DRIFTING]).max()
    d_port = np.abs(port32[DRIFTING] - ref[DRIFTING]).max()
    gap = np.abs(port32[DRIFTING] - jax32[DRIFTING]).max()
    assert d_port <= 1.25 * d_jax, (d_port, d_jax)
    assert gap > max(d_jax, d_port), (gap, d_jax, d_port)
    assert d_jax > 0.5 * MLM_PIN
    assert gap <= STATS_DRIFT


def test_over_every_statistic_and_parameter_the_port_is_no_farther(
        trajectories):
    """Summed over the 36 statistics and over every parameter leaf: the
    port's largest distances from the float64 run add up to no more than
    the JAX package's fp32 run's (by a quarter's margin); the losses of all
    three agree to 1e-5."""
    ref = trajectories["x64"][0]
    jax32, port32 = trajectories["jax32"][0], trajectories["port32"][0]
    for prefix in ("batch_stats/", "params/"):
        keys = sorted(k for k in ref if k.startswith(prefix))
        assert keys
        d_jax, d_port = _dist(jax32, ref, keys), _dist(port32, ref, keys)
        assert d_port.sum() <= 1.25 * d_jax.sum(), (prefix, d_port.sum(),
                                                    d_jax.sum())
    lx = trajectories["x64"][1]
    for name in ("jax32", "port32"):
        np.testing.assert_allclose(trajectories[name][1], lx, rtol=1e-5)
