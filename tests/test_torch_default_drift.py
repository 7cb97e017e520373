"""Where the default model's BatchNorm statistics drift comes from after ten
VQA steps (tests/test_torch_default_train.py's ``STATS_DRIFT``): the port's
fp32 trajectory and the JAX package's fp32 trajectory (CE, the setting of
that file's ``run`` fixture: ResNet one block a stage at full widths,
hidden 48, two layers, 64 px, dropout off, the identity augmentation) each
held against a third, the JAX step under ``jax_enable_x64`` with float64
parameters, statistics, optimizer state and compute (the JAX package's own
float32 casts inside, in SERF, the softmax and the loss, stay). The method
is tests/test_torch_drift.py's, which settled the flagship's drift.

The port's run lies no farther from the float64 run than the JAX package's
fp32 run, in layer4 (where the drift is largest) and summed over every
statistic and parameter leaf. In the run that set these tests it lay ten
times nearer: at ``layer4_block0/bn3/mean``, where the two fp32 runs lie
3.06e-3 apart, the port's run is 2.8e-4 from the float64 run and the JAX
package's 3.04e-3. The drift is the fp32 rounding of the JAX package's own
run, grown over ten steps through layer4's BatchNorms, not a fault of the
port.
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

from test_torch_bridge import jax_variables
from test_torch_default_model import default_configs
from test_torch_default_train import (
    LR,
    N_STEPS,
    NUM_CLASSES,
    S,
    STATS_DRIFT,
    T,
    _batch,
)
from test_torch_finetune import NOOP, _flat, _recording_tx

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

LAYER4 = "batch_stats/trans/trunk/layer4_block0/"


def _configs():
    return default_configs(
        "vqa5", max_position_embeddings=T, lr=LR, dropout_override=0.0,
        image_size=S, vocab_size=300, num_classes=NUM_CLASSES,
        loss="CrossEntropyLoss")


def _jax_trajectory(jcfg, variables, batches, x64: bool):
    """N_STEPS jitted steps of the JAX train step; float64 throughout under
    x64."""
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
        assert tree[LAYER4 + "bn1/mean"].dtype == dtype
        return {k: v.astype(np.float64) for k, v in tree.items()}, losses
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def trajectories():
    cfg, jcfg = _configs()
    rng = np.random.default_rng(41)
    batches = [_batch(cfg, rng, "vqa") for _ in range(3)]
    variables = jax_variables(jcfg)
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


def test_layer4_statistics_drift_is_fp32_noise(trajectories):
    """Over layer4's statistics, where the two fp32 runs lie farthest apart:
    the port's run is no farther from the float64 run than the JAX
    package's (within a quarter), summed and at the statistic where the
    gap is largest, and the gap stays inside STATS_DRIFT."""
    ref = trajectories["x64"][0]
    jax32, port32 = trajectories["jax32"][0], trajectories["port32"][0]
    keys = sorted(k for k in ref if k.startswith(LAYER4))
    assert len(keys) == 8
    d_jax, d_port = _dist(jax32, ref, keys), _dist(port32, ref, keys)
    gap = _dist(port32, jax32, keys)
    worst = int(np.argmax(gap))
    print(f"\nlayer4 statistics (largest gap at {keys[worst]}): "
          f"port-x64 {d_port[worst]:.3e}, jax-x64 {d_jax[worst]:.3e}, "
          f"port-jax {gap[worst]:.3e}; summed port-x64 {d_port.sum():.3e}, "
          f"jax-x64 {d_jax.sum():.3e}")
    assert d_port.sum() <= 1.25 * d_jax.sum(), (d_port.sum(), d_jax.sum())
    assert d_port[worst] <= 1.25 * d_jax[worst], (d_port[worst],
                                                  d_jax[worst])
    assert gap.max() <= STATS_DRIFT


def test_over_every_statistic_and_parameter_the_port_is_no_farther(
        trajectories):
    """Summed over every statistic and every parameter leaf: the port's
    largest distances from the float64 run add up to no more than the JAX
    package's fp32 run's (by a quarter's margin). The port's losses lie no
    farther from the float64 run's than the JAX package's (by the same
    margin), and both within a relative 5e-4 of them (6.0e-5 and 1.7e-4 in
    the run that set this test)."""
    ref = trajectories["x64"][0]
    jax32, port32 = trajectories["jax32"][0], trajectories["port32"][0]
    for prefix in ("batch_stats/", "params/"):
        keys = sorted(k for k in ref if k.startswith(prefix))
        assert keys
        d_jax, d_port = _dist(jax32, ref, keys), _dist(port32, ref, keys)
        print(f"\n{prefix}: summed port-x64 {d_port.sum():.3e}, jax-x64 "
              f"{d_jax.sum():.3e}, max port-x64 {d_port.max():.3e}, "
              f"jax-x64 {d_jax.max():.3e}")
        assert d_port.sum() <= 1.25 * d_jax.sum(), (prefix, d_port.sum(),
                                                    d_jax.sum())
    lx = np.asarray(trajectories["x64"][1])
    rel = {name: np.abs(np.asarray(trajectories[name][1]) / lx - 1).max()
           for name in ("jax32", "port32")}
    assert rel["port32"] <= 1.25 * rel["jax32"], rel
    assert max(rel.values()) <= 5e-4, rel
