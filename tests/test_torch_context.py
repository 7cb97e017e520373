"""Context parallelism and ring attention in mmvqa_tpu_torch on the CPU
(``ops/ring_attention.py``, the context axis of ``core/mesh.py`` and
``parallel/sharding.py``), against the JAX package's
``mmvqa_tpu/ops/ring_attention.py`` and its sharded steps (the counterparts
of tests/test_ring_attention.py and tests/test_context_parallel.py).

One world of four gloo ranks (``parallel/world.py``, a ``file://``
rendezvous in a temporary folder), started once for the module while this
process computes the references, runs:

* both ring cores over a context group of four, forward and gradients,
  against the JAX ring on the virtual mesh (dp=2 x cp=4) and the XLA path,
  at the JAX tests' tolerances: ``ring_vanilla_attention`` with both vjps,
  its dropout (the flash backward's gradients equal autodiff's, and with
  every keep draw True the output is the deterministic one over 1 - rate)
  and ``ring_realformer_attention`` with the carry and the mask on and off;
* the flagship's MLM step at tp=2 x cp=2 with the ring, the BERT encoder's
  at dp=2 x cp=2 with the ring, and the flagship's VQA step at dp=2 x cp=2
  with the gathered encoder, against the port's single process (loss 2e-5
  relative, gradients 1e-4, the global norm 1e-5, each parameter's change
  by ``world.update_problems``, every rank's replicated state equal) and
  the ring and VQA steps against the JAX package's sharded steps;
* ``setup_runtime``'s refusal of a ring whose length does not divide, in
  the JAX package's words.

A second world of two, spawned from a process with the JAX packages
blocked, runs a cp=2 ring step and a pp=2 step.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.cli import common as jax_common
from mmvqa_tpu.core import mesh as jax_mesh_module
from mmvqa_tpu.core.config import pretrain_config as jax_pretrain_config
from mmvqa_tpu.core.config import vqa_config as jax_vqa_config
from mmvqa_tpu.core.mesh import make_mesh as jax_make_mesh
from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.ops import attention as jax_attention
from mmvqa_tpu.ops.ring_attention import (
    ring_realformer_attention as jax_ring_realformer,
)
from mmvqa_tpu.ops.ring_attention import (
    ring_vanilla_attention as jax_ring_vanilla,
)
from mmvqa_tpu.parallel import sharding as jax_sharding
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train.state import create_train_state as jax_create_train_state

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.core.config import pretrain_config, vqa_config
from mmvqa_tpu_torch.core.mesh import make_mesh
from mmvqa_tpu_torch.data.images import AugmentSpec
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.ops.ring_attention import ring_vanilla_attention
from mmvqa_tpu_torch.parallel import sharding
from mmvqa_tpu_torch.parallel.world import (
    single_step,
    start_world,
    update_problems,
)

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RB, RH, RT, RD = 4, 4, 16, 8   # the ring cores' (B, H, T, D)
B, T, S, VOCAB, CLASSES = 8, 24, 32, 64, 10
NOOP = dict(crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0), rotation_deg=0.0,
            brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)
TIMEOUT = 240
FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=5e-5, atol=5e-6)


# ------------------------------------------------------ the ring cores ----

def _ring_mask(rng):
    m = np.ones((RB, RT), np.float32)
    for i in range(RB):
        m[i, rng.integers(RT // 2, RT):] = 0.0  # ragged padding tails
    return m


def _ring_cases():
    """name -> the global arrays and settings of a ``ring_probe`` case."""
    rng = np.random.default_rng(0)

    def arr(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    cases = {}
    vq = dict(core="vanilla", q=arr(RB, RH, RT, RD), k=arr(RB, RH, RT, RD),
              v=arr(RB, RH, RT, RD), mask=_ring_mask(rng),
              cot=arr(RB, RH, RT, RD))
    cases["vanilla-flash"] = dict(vq, vjp="flash")
    cases["vanilla-autodiff"] = dict(vq, vjp="autodiff")
    cases["dropout-flash"] = dict(vq, vjp="flash", rate=0.3, seed=3)
    cases["dropout-autodiff"] = dict(vq, vjp="autodiff", rate=0.3, seed=3)
    cases["dropout-all-kept"] = dict(vq, rate=0.25, seed=1, all_keep=True)
    for prev, mask in ((True, True), (False, True), (True, False)):
        cases[f"realformer-prev{int(prev)}-mask{int(mask)}"] = dict(
            core="realformer", q=arr(RB, RT, RH, RD), k=arr(RB, RT, RH, RD),
            v=arr(RB, RT, RH, RD),
            # the port's carry is head-major: (B, H, T, T)
            prev=arr(RB, RH, RT, RT, scale=0.3) if prev else None,
            mask=_ring_mask(rng) if mask else None,
            cot=arr(RB, RT, RH, RD), cot_scores=arr(RB, RH, RT, RT,
                                                    scale=0.1))
    return cases


RING = _ring_cases()


# ---------------------------------------------------------- the steps ----

def _kw(encoder="realformer", **over):
    kw = dict(cnn_encoder="tf_efficientnetv2_m", transformer_model=encoder,
              hidden_size=32, n_layers=2, tiny_cnn=True, image_size=S,
              max_position_embeddings=T, batch_size=B, dropout_override=0.0)
    if encoder == "transformer":
        kw["heads"] = 4
    kw.update(over)
    return kw


def _batch(kind, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(12, T + 1, size=B)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    batch = {
        "image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "tokens": (rng.integers(1, VOCAB, (B, T)) * mask).astype(np.int32),
        "segment_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
        "input_mask": mask,
        "weights": np.array([1.0] * 5 + [0.0] * 3, np.float32),
    }
    if kind == "vqa":
        batch["answer"] = rng.integers(0, CLASSES, B).astype(np.int32)
    else:
        batch["labels"] = (rng.integers(1, VOCAB, (B, T))
                           * (rng.random((B, T)) < 0.3) * mask
                           ).astype(np.int32)
    return batch


def _cfg(kind, **kw):
    if kind == "vqa":
        return vqa_config(**_kw(**kw), num_classes=CLASSES, vocab_size=VOCAB)
    # --watch: the per-module gradient norms
    return pretrain_config(**_kw(**kw), vocab_size=VOCAB, watch=True)


JOBS = {
    "realformer-tp2-cp2-ring": dict(
        cfg=_cfg("mlm", attention_impl="ring"), kind="mlm", dp=1, tp=2,
        cp=2, fsdp=False, batch=_batch("mlm", 1), aug=AugmentSpec(**NOOP)),
    "bert-dp2-cp2-ring": dict(
        cfg=_cfg("mlm", encoder="transformer", attention_impl="ring"),
        kind="mlm", dp=2, tp=1, cp=2, fsdp=False, batch=_batch("mlm", 2)),
    "vqa-dp2-cp2": dict(
        cfg=_cfg("vqa"), kind="vqa", dp=2, tp=1, cp=2, fsdp=False,
        batch=_batch("vqa", 3), aug=AugmentSpec(**NOOP)),
}
BAD_RING = _cfg("mlm", attention_impl="ring", cp_size=2,
                max_position_embeddings=25, steps_per_call=1)

BLOCKED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "mmvqa_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import mmvqa_tpu_torch.ops.ring_attention, mmvqa_tpu_torch.parallel.pipeline
from mmvqa_tpu_torch.core.config import pretrain_config
from mmvqa_tpu_torch.data.synthetic import mlm_batches
from mmvqa_tpu_torch.parallel.world import run_jobs, run_world
kw = dict(cnn_encoder="tf_efficientnetv2_m", transformer_model="realformer",
          hidden_size=32, n_layers=2, tiny_cnn=True, image_size=32,
          vocab_size=300, max_position_embeddings=12, batch_size=4)
ring = pretrain_config(attention_impl="ring", **kw)
pipe = pretrain_config(pp_size=2, **kw)
jobs = [dict(cfg=ring, kind="mlm", dp=1, tp=1, cp=2, fsdp=False, keep=[],
             batch=mlm_batches(ring, 1)[0]),
        dict(cfg=pipe, kind="mlm", dp=1, tp=1, pp=2, fsdp=False, keep=[],
             batch=mlm_batches(pipe, 1)[0])]
outs = run_world(run_jobs, 2, (jobs,), sys.argv[1], "cpu", 180)
assert all(np.isfinite(r["loss"]) and not r["jax_modules"]
           for o in outs for r in o)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mmvqa_tpu")]
assert not bad, bad
print("clean", [r["loss"] for r in outs[0]])
"""


@pytest.fixture(scope="module", autouse=True)
def started():
    """The world of four and the blocked world, started before the module's
    first test."""
    from test_torch_rank_probe import context_ranks

    folder = tempfile.mkdtemp(prefix="context_worlds_")
    world = start_world(context_ranks, 4, (list(JOBS.values()),
                                           list(RING.values()), BAD_RING),
                        os.path.join(folder, "w4"))
    blocked = subprocess.Popen(
        [sys.executable, "-c", BLOCKED, os.path.join(folder, "w2")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return world, blocked


@pytest.fixture(scope="module")
def world(started):
    """(step name -> ranks, ring case name -> rank 0's result, the ranks'
    refusals of BAD_RING)."""
    outs = started[0].results(TIMEOUT)
    steps = {name: [o[0][i] for o in outs] for i, name in enumerate(JOBS)}
    rings = {name: outs[0][1][i] for i, name in enumerate(RING)}
    return steps, rings, [o[2] for o in outs]


def test_place_batch_splits_the_token_axis():
    """dp=2 x cp=2: a rank's rows are its data coordinate's, its positions
    of every sequence field its context coordinate's block; the image keeps
    its rows only (tests/test_context_parallel.py's placement); a token
    axis that does not split raises."""
    batch = _batch("mlm", 0)
    for rank in range(4):
        spec = make_mesh(2, 1, 2, 1, world_size=4, rank=rank)
        d, c = spec.data_rank, spec.context_rank
        got = sharding.place_batch(batch, spec)
        rows = slice(d * B // 2, (d + 1) * B // 2)
        cols = slice(c * T // 2, (c + 1) * T // 2)
        for k in sharding.SEQUENCE_KEYS & set(batch):
            np.testing.assert_array_equal(got[k], batch[k][rows, cols])
        np.testing.assert_array_equal(got["image"], batch["image"][rows])
        np.testing.assert_array_equal(got["weights"], batch["weights"][rows])
    with pytest.raises(ValueError, match="not divisible by cp_size 2"):
        sharding.place_batch({"tokens": np.zeros((2, 5))},
                             make_mesh(1, 1, 2, 1, world_size=2, rank=0))


def test_ring_dropout_requires_a_generator():
    """As the JAX ring: a rate above 0 without a generator raises; at rate
    0 or deterministic the ring needs none."""
    q = torch.zeros(RB, RH, RT, RD)
    with pytest.raises(ValueError, match="dropout_rng"):
        ring_vanilla_attention(q, q, q, None, dropout_rate=0.1,
                               deterministic=False)
    out = ring_vanilla_attention(q, q, q, None, dropout_rate=0.1,
                                 deterministic=True)
    assert torch.isfinite(out).all()


def _vjp(fn, args, cot):
    y, pull = jax.vjp(fn, *args)
    return y, pull(cot)


# the cases also held to the JAX ring (each compiles a program of its own);
# every case is held to the XLA path
JAX_RING = ("vanilla-flash", "realformer-prev1-mask1")


def _jax_ring(case, ring):
    """The XLA path of a case and, with ``ring``, the JAX ring on the dp=2 x
    cp=4 virtual mesh: (outputs, gradients) of each, in the port's
    layouts."""
    mesh = jax_make_mesh(dp_size=2, tp_size=1, cp_size=4).mesh
    q, k, v = (jnp.asarray(case[x]) for x in "qkv")
    mask = None if case.get("mask") is None else jnp.asarray(case["mask"])
    out = {}
    if case["core"] == "vanilla":
        cot = jnp.asarray(case["cot"])
        fns = {"ring": lambda q, k, v: jax_ring_vanilla(
                   q, k, v, mask, mesh, vjp=case.get("vjp", "flash")),
               "xla": lambda q, k, v: jax_attention.vanilla_attention(
                   q, k, v, mask, impl="xla")}
        fns = fns if ring else {"xla": fns["xla"]}
        for name, fn in fns.items():
            y, grads = jax.jit(lambda *a, fn=fn: _vjp(fn, a, cot))(q, k, v)
            out[name] = {"out": np.asarray(y), **dict(zip(
                ("dq", "dk", "dv"), (np.asarray(g) for g in grads)))}
        return out
    # the JAX carry is (B, T, T, H): the port's is its transpose
    prev = (None if case.get("prev") is None
            else jnp.asarray(case["prev"].transpose(0, 2, 3, 1)))
    cot = jnp.asarray(case["cot"])
    cot_s = jnp.asarray(case["cot_scores"].transpose(0, 2, 3, 1))
    fns = {"ring": lambda q, k, v, p: jax_ring_realformer(q, k, v, p, mask,
                                                          mesh),
           "xla": lambda q, k, v, p: jax_attention.realformer_attention(
               q, k, v, p, mask, impl="xla")}
    fns = fns if ring else {"xla": fns["xla"]}
    for name, fn in fns.items():
        args = (q, k, v, prev) if prev is not None else (q, k, v)
        f = (lambda q, k, v, fn=fn: fn(q, k, v, None)) if prev is None else fn
        (y, sc), grads = jax.jit(lambda *a, f=f: _vjp(f, a, (cot, cot_s)))(
            *args)
        out[name] = {"out": np.asarray(y),
                     "scores": np.asarray(sc).transpose(0, 3, 1, 2),
                     "dq": np.asarray(grads[0]), "dk": np.asarray(grads[1]),
                     "dv": np.asarray(grads[2])}
        if prev is not None:
            out[name]["dprev"] = np.asarray(grads[3]).transpose(0, 3, 1, 2)
    return out


@pytest.fixture(scope="module")
def jax_rings():
    xla = {"vanilla-autodiff": "vanilla-flash"}  # the same inputs
    out = {name: _jax_ring(case, name in JAX_RING)
           for name, case in RING.items()
           if not case.get("rate") and name not in xla}
    return {**out, **{a: out[b] for a, b in xla.items()}}


@pytest.mark.parametrize("name", [n for n, c in RING.items()
                                  if not c.get("rate")])
def test_ring_core_matches_the_jax_ring_and_xla(jax_rings, world, name):
    """Forward (and the carried scores) and the gradients of q, k, v (and
    the carry) against the XLA path, and for ``JAX_RING``'s cases against
    the JAX ring too."""
    got, want = world[1][name], jax_rings[name]
    for ref in want:
        np.testing.assert_allclose(got["out"], want[ref]["out"], **FWD)
        if "scores" in got:
            np.testing.assert_allclose(got["scores"], want[ref]["scores"],
                                       rtol=2e-5, atol=2e-5)
        for g in ("dq", "dk", "dv", "dprev"):
            if g in want[ref]:
                np.testing.assert_allclose(got[g], want[ref][g],
                                           err_msg=f"{ref} {g}", **GRAD)


def test_ring_dropout_flash_backward_equals_autodiff(world):
    """With dropout on, the flash backward redraws the forward's keep masks
    (the same folded seeds): its gradients are autodiff's."""
    a, b = world[1]["dropout-flash"], world[1]["dropout-autodiff"]
    np.testing.assert_array_equal(a["out"], b["out"])
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(a[g], b[g], err_msg=g, **GRAD)
    assert not np.allclose(a["out"], world[1]["vanilla-flash"]["out"])


def test_ring_dropout_hits_the_numerator_only(world, jax_rings):
    """Every keep draw True: the output is the deterministic one over
    1 - rate (the normaliser keeps the raw exponentials)."""
    got = world[1]["dropout-all-kept"]["out"]
    det = jax_rings["vanilla-flash"]["xla"]["out"]
    np.testing.assert_allclose(got, det / (1.0 - 0.25), **FWD)


@pytest.fixture(scope="module")
def singles():
    return {name: single_step(job, "cpu") for name, job in JOBS.items()}


@pytest.mark.parametrize("name", list(JOBS))
def test_context_step_equals_the_single_process_step(singles, world, name):
    """Loss, the reduced gradients, their global norm, the statistics, each
    parameter's change, every rank's replicated state, no JAX."""
    ranks, ref = world[0][name], singles[name]
    r0 = ranks[0]
    assert abs(r0["loss"] - ref["loss"]) <= 2e-5 * max(1.0, abs(ref["loss"]))
    assert r0["grads"].keys() == ref["grads"].keys()
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(np.asarray(r0["grads"][k]),
                                   np.asarray(want), rtol=0, atol=1e-4,
                                   err_msg=k)
    for r in ranks:
        assert r["loss"] == r0["loss"]
        assert r["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)
        assert r["digest"] == r0["digest"] and not r["jax_modules"]
    for k in (k for k in ref["state"] if k.endswith("running_var")):
        np.testing.assert_allclose(r0["state"][k], ref["state"][k], rtol=0,
                                   atol=1e-4, err_msg=k)
    problems, held, dropped = update_problems(
        ref["before"], r0["state"], ref["state"], ref["grads"],
        JOBS[name]["cfg"].lr)
    assert problems == [] and held > 20 * dropped, (problems[:3], held)
    if JOBS[name]["kind"] == "vqa":  # the global batch's predictions
        assert np.array_equal(r0["metrics"]["preds"], ref["metrics"]["preds"])


@pytest.mark.parametrize("name", [n for n in JOBS
                                  if JOBS[n]["kind"] == "mlm"])
def test_context_module_norms_are_the_single_process_ones(singles, world,
                                                          name):
    """--watch under context parallelism (with the ring and without, with
    tp and with dp): every rank's ``gnorm/<module>`` is the single
    process's (1e-5 relative)."""
    want = {k: float(v) for k, v in singles[name]["metrics"].items()
            if k.startswith("gnorm/")}
    assert len(want) >= 7
    for r in world[0][name]:
        got = {k: float(v) for k, v in r["metrics"].items()
               if k.startswith("gnorm/")}
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), (r["rank"], k)


def _jax_step(name, tp, cp, ring):
    """The JAX package's step of a job on a (dp, tp, cp) mesh of the virtual
    devices from the port's initial weights: (loss, state after it)."""
    job = JOBS[name]
    dp = 4 // (tp * cp)
    make = jax_vqa_config if job["kind"] == "vqa" else jax_pretrain_config
    extra = (dict(num_classes=CLASSES) if job["kind"] == "vqa" else {})
    jcfg = make(**_kw(), vocab_size=VOCAB, **extra)
    port = MMBert(job["cfg"], device="cpu")
    variables = bridge.to_flax(port.state_dict(), port)
    spec = jax_make_mesh(dp, tp, cp, 1, devices=jax.devices()[:4])
    saved = (jax_attention.IMPL_DEFAULT, jax_attention.RING_MESH,
             jax_mesh_module.CURRENT)
    try:
        if ring:
            jax_attention.IMPL_DEFAULT = "ring"
            jax_attention.RING_MESH = spec.mesh
        state = jax_sharding.place_state(jax_create_train_state(
            jax.tree.map(jnp.asarray, variables), jcfg.lr), spec)
        make_steps = (jax_steps.make_vqa_steps if job["kind"] == "vqa"
                      else jax_steps.make_mlm_steps)
        step, _ = make_steps(JaxMMBert(jcfg), jcfg,
                             aug=JaxAugmentSpec(**NOOP))
        state, m = step(state, jax_sharding.place_batch(job["batch"], spec),
                        jax.random.PRNGKey(0))
        after = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    finally:
        (jax_attention.IMPL_DEFAULT, jax_attention.RING_MESH,
         jax_mesh_module.CURRENT) = saved
    return float(m["loss"]), bridge.to_state_dict(after, port)


@pytest.fixture(scope="module")
def jax_sharded():
    return {"realformer-tp2-cp2-ring": _jax_step("realformer-tp2-cp2-ring",
                                                 2, 2, True),
            "vqa-dp2-cp2": _jax_step("vqa-dp2-cp2", 1, 2, False)}


@pytest.mark.parametrize("name", ["realformer-tp2-cp2-ring", "vqa-dp2-cp2"])
def test_context_step_equals_the_jax_sharded_step(jax_sharded, singles,
                                                  world, name):
    """The loss at the JAX tests' 2e-5 and each parameter's change against
    the JAX package's step on the same layout (the ring by its
    ``IMPL_DEFAULT``, the gathered encoder by GSPMD)."""
    loss, state = jax_sharded[name]
    got = world[0][name][0]
    assert abs(got["loss"] - loss) <= 2e-5 * max(1.0, abs(loss))
    ref = dict(singles[name], state={k: v.numpy() for k, v in state.items()})
    problems, held, dropped = update_problems(
        ref["before"], got["state"], ref["state"], ref["grads"],
        JOBS[name]["cfg"].lr)
    assert problems == [] and held > 20 * dropped, (problems[:3], held)


def test_a_ring_whose_length_does_not_divide_is_refused(world):
    """Every rank's ``setup_runtime`` refuses --attention_impl ring at a
    sequence length cp does not divide, with the JAX package's message."""
    jcfg = jax_pretrain_config(**_kw(attention_impl="ring", cp_size=2,
                                     max_position_embeddings=25),
                               vocab_size=VOCAB, dp_size=4)
    saved = (jax_attention.IMPL_DEFAULT, jax_attention.RING_MESH,
             jax_mesh_module.CURRENT)
    try:
        with pytest.raises(ValueError) as want:
            jax_common.setup_runtime(jcfg)
    finally:
        (jax_attention.IMPL_DEFAULT, jax_attention.RING_MESH,
         jax_mesh_module.CURRENT) = saved
    assert world[2] == [str(want.value)] * 4


def test_a_world_steps_without_jax(started):
    """The new modules import with the JAX packages blocked, and a spawned
    world of two gloo ranks completes a cp=2 ring step and a pp=2 step."""
    out, err = started[1].communicate(timeout=TIMEOUT)
    assert started[1].returncode == 0, err[-3000:]
    assert out.strip().splitlines()[-1].startswith("clean")
