"""The multi-GPU layouts of mmvqa_tpu_torch on the CPU: ranks spawned under
gloo (``parallel/world.py``, a ``file://`` rendezvous in ``tmp_path``, so
no port is shared between test workers) run one train step each under
data parallelism, FSDP, tensor parallelism and their composition, held to
the port's single-process step on the same global batch, and the most
composed layout to the JAX package's sharded step on the virtual mesh.

A world's start-up is paid once: each world runs several layouts in turn
(``world.run_jobs``). The batches carry a padded last sample, so that the
data ranks hold different sums of weights, and the port's steps augment
with their own generators (the global batch's draws, each rank its rows);
the JAX comparison takes the identity augmentation, whose draws both
packages share. The loss is held at the JAX tests' 2e-5
(tests/test_fsdp.py), gradients and BatchNorm statistics at 1e-4, the
gradient's global norm and the clip's at 1e-5 relative, and each
parameter's change in the step at 2% of lr (``world.update_problems``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.core.config import pretrain_config as jax_pretrain_config
from mmvqa_tpu.core.mesh import make_mesh as jax_make_mesh
from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.parallel import sharding as jax_sharding
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train.state import create_train_state as jax_create_train_state

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.core.config import pretrain_config, vqa_config
from mmvqa_tpu_torch.data.images import AugmentSpec
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.parallel.world import (
    UPDATE_TOL,
    run_world,
    single_step,
    site_problems,
    update_problems,
)
from mmvqa_tpu_torch.train.state import CLIP_NORM

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, S, VOCAB, CLASSES = 8, 16, 32, 64, 10
NOOP = dict(crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0), rotation_deg=0.0,
            brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)
MODEL = dict(cnn_encoder="tf_efficientnetv2_m", transformer_model="realformer",
             hidden_size=64, n_layers=2, tiny_cnn=True, image_size=S,
             max_position_embeddings=T, batch_size=B, dropout_override=0.0)
TIMEOUT = 240


# the feedback encoder at tp=2 (its 8 heads of 64 whatever the width)
FEEDBACK = dict(transformer_model="feedback-transformer", hidden_size=48)


def _cfg(kind, **kw):
    if kind == "vqa":
        return vqa_config(**MODEL, num_classes=CLASSES, vocab_size=VOCAB)
    # --watch: the per-module gradient norms of every MLM and SupCon step
    return pretrain_config(**{**MODEL, **kw}, vocab_size=VOCAB,
                           supcon=kind == "supcon", watch=True)


def _batch(kind, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, T + 1, size=B)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)

    def tokens():
        return (rng.integers(1, VOCAB, (B, T)) * mask).astype(np.int32)

    def labels():
        return (rng.integers(1, VOCAB, (B, T)) * (rng.random((B, T)) < 0.3)
                * mask).astype(np.int32)

    batch = {
        "image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "tokens": tokens(),
        "segment_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
        "input_mask": mask,
        # rank 0 holds four real samples, rank 1 one (at dp = 2)
        "weights": np.array([1.0] * 5 + [0.0] * 3, np.float32),
    }
    if kind == "vqa":
        batch["answer"] = rng.integers(0, CLASSES, B).astype(np.int32)
    else:
        batch["labels"] = labels()
    if kind == "supcon":
        batch["aug_tokens"], batch["aug_labels"] = tokens(), labels()
    return batch


def _job(kind, dp, tp, fsdp, seed, cfg=None, **kw):
    return dict(cfg=cfg or _cfg(kind), kind=kind, dp=dp, tp=tp, fsdp=fsdp,
                batch=_batch(kind, seed), **kw)


# ``hist``: the --watch_histograms pass in the world (``world._hist_pass``)
WORLD2 = {
    "mlm-dp2": _job("mlm", 2, 1, False, 1),
    "mlm-dp2-fsdp": _job("mlm", 2, 1, True, 2),
    "mlm-tp2": _job("mlm", 1, 2, False, 3, hist=True),
    "supcon-dp2": _job("supcon", 2, 1, False, 4),
    "vqa-tp2-clip": _job("vqa", 1, 2, False, 5, clip=True, lr=1e-3),
    # identity augmentation: the JAX sharded step takes the same images
    "feedback-tp2": _job("mlm", 1, 2, False, 8, cfg=_cfg("mlm", **FEEDBACK),
                         aug=AugmentSpec(**NOOP)),
}
WORLD4 = {"mlm-dp2-tp2-fsdp": _job("mlm", 2, 2, True, 7,
                                   aug=AugmentSpec(**NOOP), hist=True)}
FSDP = ("mlm-dp2-fsdp", "mlm-dp2-tp2-fsdp")
RESUMED = "mlm-dp2-fsdp"  # resumes from its recorder for a second step
FEEDBACK_SAVED = "feedback-tp2"


def _spawn(jobs, world_size, tmp_path, fn=None):
    from test_torch_rank_probe import small_jobs

    return run_world(fn or small_jobs, world_size, (list(jobs.values()),),
                     str(tmp_path / "rendezvous"), "cpu", TIMEOUT)


SAVED = "mlm-dp2-tp2-fsdp"  # the layout whose checkpoints are read back


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    return tmp_path_factory.mktemp("saved")


def _by_name(jobs, outs):
    return {name: [o[i] for o in outs] for i, name in enumerate(jobs)}


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    return tmp_path_factory.mktemp("resumed")


@pytest.fixture(scope="module")
def feedback_saved(tmp_path_factory):
    return tmp_path_factory.mktemp("feedback_saved")


@pytest.fixture(scope="module")
def world2(tmp_path_factory, resumed, feedback_saved):
    """The world of two: its layouts and the host-side helpers."""
    from test_torch_rank_probe import jobs_and_shards

    jobs = dict(WORLD2)
    jobs[RESUMED] = dict(jobs[RESUMED], resume_dir=str(resumed))
    jobs[FEEDBACK_SAVED] = dict(jobs[FEEDBACK_SAVED],
                                save_dir=str(feedback_saved))
    outs = _spawn(jobs, 2, tmp_path_factory.mktemp("world2"),
                  jobs_and_shards)
    return _by_name(WORLD2, [o[0] for o in outs]), [o[1] for o in outs]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, saved, world2):
    out = dict(world2[0])
    jobs4 = dict(WORLD4)
    jobs4[SAVED] = dict(jobs4[SAVED], save_dir=str(saved))
    out.update(_by_name(jobs4, _spawn(jobs4, 4,
                                      tmp_path_factory.mktemp("world4"))))
    return out


@pytest.fixture(scope="module")
def singles(resumed):
    jobs = {**WORLD2, **WORLD4}
    jobs[RESUMED] = dict(jobs[RESUMED], resume_dir=str(resumed))
    return {name: single_step(job, "cpu") for name, job in jobs.items()}


def _close(got, want, atol, what):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=f"{what} {k}")


LAYOUTS = list(WORLD2) + list(WORLD4)


def _lr(name):
    return (WORLD2.get(name) or WORLD4[name]).get("lr", 2e-5)


def _scale(ref):
    """The clip's scale in the reference step (1 without a clip)."""
    return min(1.0, CLIP_NORM / ref["clip_norm"]) if "clip_norm" in ref \
        else 1.0


def _updates_like(after, ref, lr, what):
    """``after`` changed each parameter as the reference step did
    (``world.update_problems``); most entries are held."""
    problems, held, dropped = update_problems(
        ref["before"], after, ref["state"], ref["grads"], lr, _scale(ref))
    assert problems == [], f"{what}: {problems[:3]}"
    assert held > 20 * dropped, (held, dropped)


@pytest.mark.parametrize("name", LAYOUTS)
def test_sharded_step_equals_the_single_process_step(worlds, singles, name):
    """Loss, the reduced gradients, the BatchNorm statistics and each
    parameter's change in the update, as rank 0 gathers them."""
    ranks, ref = worlds[name], singles[name]
    assert abs(ranks[0]["loss"] - ref["loss"]) <= 2e-5 * max(
        1.0, abs(ref["loss"]))
    for r in ranks:  # every rank holds the global loss
        assert r["loss"] == ranks[0]["loss"]
    got, want = ranks[0]["grads"], ref["grads"]
    assert got.keys() == want.keys()
    _close(got, want, 1e-4, "gradient")
    stats = [k for k in ref["state"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert stats
    buffers = [k for k in ref["state"] if k not in ref["grads"]]
    assert set(stats) <= set(buffers)
    _close({k: ranks[0]["state"][k] for k in buffers},
           {k: ref["state"][k] for k in buffers}, 1e-4, "statistic")
    _updates_like(ranks[0]["state"], ref, _lr(name), name)


@pytest.mark.parametrize("name", LAYOUTS)
def test_global_norm_and_clip_are_the_single_process_ones(worlds, singles,
                                                          name):
    """``Layout.global_norm`` of the reduced gradient is the norm of the
    full gradient rank 0 gathers and the single process's, on every rank;
    under ``clip`` the norm the clip measured is the single process's, and
    above CLIP_NORM, so that the clip scales."""
    ranks, ref = worlds[name], singles[name]
    full = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                       for g in ranks[0]["grads"].values()))
    for r in ranks:
        assert r["grad_norm"] == pytest.approx(full, rel=1e-5)
        assert r["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)
    clipped = (WORLD2.get(name) or WORLD4[name]).get("clip", False)
    assert ("clip_norm" in ref) == clipped
    if clipped:
        assert ref["clip_norm"] > CLIP_NORM
        for r in ranks:
            assert r["clip_norm"] == pytest.approx(ref["clip_norm"],
                                                   rel=1e-5)


@pytest.mark.parametrize("name", LAYOUTS)
def test_every_rank_holds_the_same_state_and_no_jax(worlds, name):
    """Replicated tensors are equal on every rank after the step (the
    running statistics too), and no rank imported a JAX package."""
    ranks = worlds[name]
    for r in ranks[1:]:
        assert r["digest"] == ranks[0]["digest"]
        assert r["grad_digest"] == ranks[0]["grad_digest"]
    assert all(not r["jax_modules"] for r in ranks)


@pytest.mark.parametrize("name", LAYOUTS)
def test_kernel_sites_run_on_local_shards(worlds, singles, name):
    """K1 on (B / dp, P, K) x (K, C / tp), K2 on H / tp heads of B / dp, K3
    on the local channels of the column-parallel blocks, and K4 at every
    site but the row-parallel ones under tp > 1 (``world.site_problems``,
    which the card's smoke applies to its ranks as well)."""
    job = WORLD2.get(name) or WORLD4[name]
    ref = singles[name]["sites"]
    layers = 0 if name.startswith("feedback") else 2  # no K2 in feedback
    assert len(ref["K1"]) == 5 and len(ref["K2"]) == layers and ref["K3"]
    for r in worlds[name]:
        assert site_problems(ref, r["sites"], job["dp"], job["tp"]) == []
    if job["tp"] > 1:  # the row-parallel pw_proj sites left K4
        assert len(worlds[name][0]["sites"]["K4"]) < len(ref["K4"])


def test_layouts_split_and_count_what_they_should(worlds):
    """FSDP shards really shard, tp really splits the heads, and the
    padded batch leaves its ranks with different sums of weights."""
    w = WORLD2["mlm-dp2"]["batch"]["weights"]
    assert w[:4].sum() != w[4:].sum()
    assert worlds["mlm-tp2"][0]["sites"]["K2"][0][2] == 4  # 8 heads / 2
    assert worlds["vqa-tp2-clip"][0]["metrics"]["preds"].shape == (B,)


@pytest.fixture(scope="module")
def jax_sharded(worlds):
    """The JAX package's MLM step on a dp=2 x tp=2 FSDP mesh of the virtual
    devices, from the port's initial weights, identity augmentation."""
    job = WORLD4["mlm-dp2-tp2-fsdp"]
    kw = {k: v for k, v in MODEL.items()}
    jcfg = jax_pretrain_config(**kw, vocab_size=VOCAB, watch=True)
    model = MMBert(job["cfg"], device="cpu")
    variables = bridge.to_flax(model.state_dict(), model)
    saved = jax_sharding.FSDP_MIN_SIZE
    jax_sharding.FSDP_MIN_SIZE = 0
    try:
        return _jax_step(job, jcfg, model, variables, (2, 2), True)
    finally:
        jax_sharding.FSDP_MIN_SIZE = saved


def _jax_step(job, jcfg, model, variables, mesh, fsdp):
    """One JAX MLM step on a (dp, tp) mesh of the virtual devices: the
    loss, the state after it in the port's names, and --watch's norms."""
    spec = jax_make_mesh(*mesh, 1, 1, devices=jax.devices()[:mesh[0] * mesh[1]])
    state = jax_sharding.place_state(jax_create_train_state(
        jax.tree.map(jnp.asarray, variables), jcfg.lr), spec, fsdp=fsdp)
    step, _ = jax_steps.make_mlm_steps(JaxMMBert(jcfg), jcfg,
                                       aug=JaxAugmentSpec(**NOOP))
    state, m = step(state, jax_sharding.place_batch(job["batch"], spec),
                    jax.random.PRNGKey(0))
    after = jax.device_get({"params": state.params,
                            "batch_stats": state.batch_stats})
    norms = {k: float(v) for k, v in m.items() if k.startswith("gnorm/")}
    return float(m["loss"]), bridge.to_state_dict(after, model), norms


def test_sharded_step_equals_the_jax_sharded_step(worlds, singles,
                                                  jax_sharded):
    """The loss, the statistics and each parameter's change against the
    JAX step's (entries held by the port's single-process gradient, the
    JAX step returns none)."""
    loss, state, _ = jax_sharded
    name = "mlm-dp2-tp2-fsdp"
    got = worlds[name][0]
    assert abs(got["loss"] - loss) <= 2e-5 * max(1.0, abs(loss))
    stats = {k: v.numpy() for k, v in state.items()
             if k.endswith(("running_mean", "running_var"))}
    _close({k: got["state"][k] for k in stats}, stats, 1e-4, "statistic")
    ref = dict(singles[name], state={k: v.numpy() for k, v in state.items()})
    _updates_like(got["state"], ref, _lr(name), "against JAX")


WATCHED = [n for n in LAYOUTS if (WORLD2.get(n) or WORLD4[n])["kind"]
           != "vqa"]


def _norms(metrics):
    return {k: float(v) for k, v in metrics.items() if k.startswith("gnorm/")}


@pytest.mark.parametrize("name", WATCHED)
def test_module_norms_are_the_single_process_ones(worlds, singles, name):
    """--watch under a layout: every rank's ``gnorm/<module>`` is the norm
    of the reduced gradient of that module, as the single process takes it
    (1e-5 relative), the same modules, and together they make up the
    global norm."""
    want = _norms(singles[name]["metrics"])
    assert len(want) >= 7
    for r in worlds[name]:
        got = _norms(r["metrics"])
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), (r["rank"], k)
        total = np.sqrt(sum(np.square(v) for v in got.values()))
        assert total == pytest.approx(r["grad_norm"], rel=1e-5)


def test_module_norms_equal_the_jax_sharded_steps(worlds, jax_sharded):
    """The dp=2 x tp=2 FSDP world's norms against the JAX sharded step's
    ``_grad_norms`` of its global gradient."""
    want = jax_sharded[2]
    assert len(want) >= 7
    for r in worlds["mlm-dp2-tp2-fsdp"]:
        got = _norms(r["metrics"])
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), (r["rank"], k)


HIST = [n for n in LAYOUTS if (WORLD2.get(n) or WORLD4[n]).get("hist")]
HIST_TOL = 1e-5


def binned(values):
    """``train.steps._histograms`` of one tensor in numpy float32, the same
    operations in the same order: (counts, lo, hi)."""
    x = np.asarray(values, np.float32).reshape(-1)
    lo, hi = x.min(), x.max()
    width = np.maximum(hi - lo, np.float32(1e-12))
    idx = np.clip(((x - lo) / width * 64).astype(np.int32), 0, 63)
    return np.bincount(idx, minlength=64), lo, hi


def hist_problems(got, want, values, diff):
    """A layout's histogram entry (counts, lo, hi) against the single
    process's, whose tensor is ``values``, ``diff`` being the largest
    difference between the two processes' tensors (a gradient leaf of
    rounding noise, 1e-9 where its neighbours are 1e-2, differs by its own
    size): lo and hi within tol = HIST_TOL of the range's magnitude plus
    ``diff`` (a minimum moves by no more than its tensor's entries), the
    counts summing to the tensor's elements, and the counts per bin equal
    but where a value lies within 2 tol of a bin edge (the value moves by
    up to ``diff``, the edge by up to tol): rounding may put it in either
    bin, so the bins may differ by two counts a such value."""
    counts, lo, hi = (np.asarray(x) for x in got)
    rc, rlo, rhi = (np.asarray(x) for x in want)
    scale = max(abs(float(rlo)), abs(float(rhi)), 1e-30)
    tol = HIST_TOL * scale + diff
    out = []
    if not (abs(lo - rlo) <= tol and abs(hi - rhi) <= tol):
        out.append(f"lo, hi {lo}, {hi} against {rlo}, {rhi}")
    if not counts.sum() == rc.sum() == values.size:
        out.append(f"counts sum to {counts.sum()}, {rc.sum()}, not "
                   f"{values.size}")
    moved = int(np.abs(counts.astype(np.int64) - rc).sum())
    if moved:
        step = (float(rhi) - float(rlo)) / len(rc)  # the bins' width
        pos = (values.reshape(-1) - float(rlo)) / max(step, 1e-300)
        near = (np.abs(pos - np.round(pos)) * step <= 2 * tol).sum()
        if moved > 2 * near:
            out.append(f"counts differ by {moved}, {near} values near an "
                       "edge")
    return out


@pytest.mark.parametrize("name", HIST)
def test_histograms_under_a_layout_are_the_single_process_ones(
        worlds, singles, name):
    """--watch_histograms under a layout: every rank bins the full reduced
    gradient and the full weights under the single process's names (the
    counts, lo and hi of rank 0's gathered gradient and of the seeded
    weights, bit for bit: the pass runs before the step, on its draws), as
    the single process does (``hist_problems``), and the pass leaves every
    rank's state as it was, before the step and after it."""
    ref = singles[name]
    model = MMBert((WORLD2.get(name) or WORLD4[name])["cfg"], device="cpu")
    torch_name = {v: k for k, v in bridge.flax_names(model).items()}
    assert ref["hist_kept_state"]
    assert len(ref["hist"]) == 2 * len(torch_name)
    grads = worlds[name][0]["grads"]
    for r in worlds[name]:
        assert r["hist_kept_state"], r["rank"]
        assert r["hist"].keys() == ref["hist"].keys()
        for key, want in ref["hist"].items():
            kind, _, path = key.partition("/")
            k = torch_name[path]
            mine = grads[k] if kind == "ghist" else ref["before"][k]
            exact = binned(mine)
            for a, b in zip(r["hist"][key], exact):
                np.testing.assert_array_equal(a, b, err_msg=key)
            theirs = np.asarray(ref["grads" if kind == "ghist" else
                                    "before"][k], np.float64)
            diff = float(np.abs(np.asarray(mine, np.float64) - theirs).max())
            problems = hist_problems(r["hist"][key], want, theirs, diff)
            assert problems == [], (r["rank"], key, problems)


@pytest.mark.parametrize("name", FSDP)
def test_fsdp_holds_its_leaves_as_blocks_at_rest(worlds, name):
    """Between steps every FSDP leaf's parameter on every rank is its 1/dp
    block of the 'model' block (ZeRO-3's memory), in storage of its own
    size, with no gathered tensor left in its module; Adam's moments are
    the blocks' too (the recorder's round trip and the update tests)."""
    job = WORLD2.get(name) or WORLD4[name]
    for r in worlds[name]:
        assert r["rest_problems"] == [], r["rest_problems"][:3]
        leaves = r["fsdp_leaves"]
        assert len(leaves) > 20
        for k, (local, full, tp_split) in leaves.items():
            assert local * job["dp"] * (job["tp"] if tp_split else 1) \
                == full, k


# Adam's second update lr m / (sqrt(v) + eps) moves by at most 1.13 lr
# dg / |g2| when either step's gradient moves by dg (the largest derivative
# of m / sqrt(v) over the first gradient, times |g2|): it stays within
# UPDATE_TOL lr where |g2| >= 1.13 dg / UPDATE_TOL, which
# ``update_problems`` holds as twice its ``grad_tol``
SECOND_STEP = 1.13 / UPDATE_TOL / 2


def test_fsdp_resumes_from_its_recorder(worlds, singles):
    """dp=2 FSDP saves its recorder after a step, restores it into a new
    model, layout and state, and takes a second step: the same step as on
    the saved state in memory, bit for bit, on every rank; its loss and
    each parameter's change are the single process's doing the same, at
    the entries whose gradient lies far enough from 0 for the first step's
    difference (``SECOND_STEP``)."""
    ranks, ref = worlds[RESUMED], singles[RESUMED]
    assert ref["resumed_as_kept"]
    assert all(r["resumed_as_kept"] for r in ranks)
    assert abs(ranks[0]["resumed_loss"] - ref["resumed_loss"]) <= 2e-5 * max(
        1.0, abs(ref["resumed_loss"]))
    assert all(r["resumed_loss"] == ranks[0]["resumed_loss"] for r in ranks)
    assert ranks[0]["resumed_adam_steps"] == ref["resumed_adam_steps"] == [2]
    # the second step's change from each one's own state after the first
    # (an entry whose first gradient lay near 0 may have stepped either way)
    own = {k: np.asarray(ref["state"][k], np.float64)
           + np.asarray(ranks[0]["resumed_state"][k], np.float64)
           - np.asarray(ranks[0]["state"][k], np.float64)
           for k in ref["resumed_grads"]}
    tol = {k: SECOND_STEP * float(np.abs(np.asarray(ranks[0]["grads"][k])
                                         - ref["grads"][k].numpy()).max())
           for k in ref["resumed_grads"]}
    problems, held, dropped = update_problems(
        ref["state"], own, ref["resumed_state"], ref["resumed_grads"],
        _lr(RESUMED), grad_tol=tol)
    assert problems == [], problems[:3]
    assert held > 20 * dropped, (held, dropped)


def test_feedback_memory_holds_this_ranks_heads(worlds, singles):
    """Under tp=2 each window's memory of keys holds the rank's heads:
    inner / 2 columns, where the single process holds inner."""
    ref = singles["feedback-tp2"]["sites"]["memory"]
    assert len(ref) == -(-T // 2) and ref[0][2] == 8 * 64
    for r in worlds["feedback-tp2"]:
        assert r["sites"]["memory"] == [m[:2] + (m[2] // 2,) for m in ref]


def test_feedback_tp2_checkpoint_is_the_single_process_file(
        worlds, singles, feedback_saved):
    """The feedback encoder's tp=2 weights file is one process's: it loads
    into a single process and holds the layout's state after the step bit
    for bit; every rank restored its recorder to the blocks it held."""
    from mmvqa_tpu_torch.train import checkpoint

    name = "feedback-tp2"
    assert all(r["reloaded_equal"] for r in worlds[name])
    model = MMBert(WORLD2[name]["cfg"], device="cpu")
    weights = checkpoint.load_weights(str(feedback_saved / "weights"))
    model.load_state_dict(weights, strict=True)
    after = worlds[name][0]["state"]
    assert weights.keys() == after.keys()
    for k, v in weights.items():
        np.testing.assert_array_equal(v.numpy(), after[k], err_msg=k)
    _updates_like(weights, singles[name], _lr(name), "weights")


@pytest.fixture(scope="module")
def jax_feedback(worlds):
    """The JAX package's feedback MLM step on a (1, 2) mesh of the virtual
    devices, from the port's initial weights, identity augmentation."""
    job = WORLD2["feedback-tp2"]
    jcfg = jax_pretrain_config(**{**MODEL, **FEEDBACK}, vocab_size=VOCAB,
                               watch=True)
    model = MMBert(job["cfg"], device="cpu")
    variables = bridge.to_flax(model.state_dict(), model)
    return _jax_step(job, jcfg, model, variables, (1, 2), False)


def test_feedback_tp2_equals_the_jax_sharded_step(worlds, singles,
                                                  jax_feedback):
    """The feedback encoder at tp=2: the loss, the statistics, each
    parameter's change and the module norms against the JAX sharded
    step's."""
    loss, state, norms = jax_feedback
    name = "feedback-tp2"
    got = worlds[name][0]
    assert abs(got["loss"] - loss) <= 2e-5 * max(1.0, abs(loss))
    stats = {k: v.numpy() for k, v in state.items()
             if k.endswith(("running_mean", "running_var"))}
    _close({k: got["state"][k] for k in stats}, stats, 1e-4, "statistic")
    ref = dict(singles[name], state={k: v.numpy() for k, v in state.items()})
    _updates_like(got["state"], ref, _lr(name), "against JAX")
    for r in worlds[name]:
        mine = _norms(r["metrics"])
        assert mine.keys() == norms.keys()
        for k in norms:
            assert mine[k] == pytest.approx(norms[k], rel=1e-5), (r["rank"], k)


BLOCKED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "mmvqa_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import mmvqa_tpu_torch.core.distributed, mmvqa_tpu_torch.core.mesh
import mmvqa_tpu_torch.parallel.comm, mmvqa_tpu_torch.parallel.sharding
from mmvqa_tpu_torch.core.config import pretrain_config
from mmvqa_tpu_torch.data.synthetic import mlm_batches
from mmvqa_tpu_torch.parallel.world import run_jobs, run_world
cfg = pretrain_config(cnn_encoder="tf_efficientnetv2_m",
                      transformer_model="realformer", hidden_size=32,
                      n_layers=1, tiny_cnn=True, image_size=32, vocab_size=300,
                      max_position_embeddings=12, batch_size=4)
job = dict(cfg=cfg, kind="mlm", dp=2, tp=1, fsdp=False, keep=[],
           batch=mlm_batches(cfg, 1)[0])
outs = run_world(run_jobs, 2, ([job],), sys.argv[1], "cpu", 120)
assert all(np.isfinite(o[0]["loss"]) and not o[0]["jax_modules"]
           for o in outs)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mmvqa_tpu")]
assert not bad, bad
print("clean", outs[0][0]["loss"])
"""


def test_a_world_steps_without_jax(tmp_path):
    """Every new module imports with the JAX packages blocked, and a
    spawned world of two gloo ranks completes a dp=2 step."""
    out = subprocess.run([sys.executable, "-c", BLOCKED,
                          str(tmp_path / "rendezvous")], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("clean")


def test_process_shard_host_mean_and_loader_shards(world2):
    """Two ranks (tests/test_multihost.py's contract for the JAX package):
    ``process_shard`` is the rank's data coordinate, ``all_hosts_mean``
    averages a host scalar over the world, and the loader's strided shards
    are disjoint, cover the dataset and step together (the shorter shard
    pads with weight-0 rows), each batch carrying its dataset indices."""
    outs = world2[1]
    assert [o[:3] for o in outs] == [(0, 2, 1.5), (1, 2, 1.5)]
    b0, b1 = outs[0][3], outs[1][3]
    assert len(b0) == len(b1) == 3
    real = [x for b in (b0, b1) for xs, ws, _ in b
            for x, w in zip(xs, ws) if w > 0]
    assert sorted(real) == list(range(9))
    assert [x for xs, ws, _ in b0 for x, w in zip(xs, ws) if w > 0] == [
        0, 2, 4, 6, 8]
    assert all(xs == ix for b in (b0, b1) for xs, _, ix in b)


def test_checkpoints_of_a_layout_are_the_single_process_files(worlds,
                                                              singles, saved):
    """Under dp=2 x tp=2 with FSDP rank 0 writes the weights and the
    recorder as one process holds them: they load into a single process
    (the layout's state after the step bit for bit, Adam's moments of
    every parameter at their full shapes), and every rank restores the
    recorder to the blocks it held."""
    from mmvqa_tpu_torch.train import checkpoint
    from mmvqa_tpu_torch.train.state import create_train_state

    assert all(r["reloaded_equal"] for r in worlds[SAVED])
    job, ref = WORLD4[SAVED], singles[SAVED]
    model = MMBert(job["cfg"], device="cpu")
    weights = checkpoint.load_weights(str(saved / "weights"))
    model.load_state_dict(weights, strict=True)
    after = worlds[SAVED][0]["state"]
    assert weights.keys() == after.keys()
    for k, v in weights.items():
        np.testing.assert_array_equal(v.numpy(), after[k], err_msg=k)
    _updates_like(weights, ref, _lr(SAVED), "weights")
    state = create_train_state(model, job["cfg"].lr)
    state, scheduler, epoch = checkpoint.restore_recorder(str(saved), state)
    assert epoch == 0 and scheduler == {"lr": job["cfg"].lr}
    moments = state.optimizer.state_dict()["state"]
    names = [n for n, _ in model.named_parameters()]
    assert len(moments) == len(names)
    for i, name in enumerate(names):
        # Adam's first moment after one step is 0.1 x the gradient
        np.testing.assert_allclose(moments[i]["exp_avg"].numpy(),
                                   0.1 * ref["grads"][name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_vqa_clis_under_layouts_write_the_single_process_files(tmp_path):
    """``vqa_train --dp_size 2 --fsdp --watch_histograms`` in a world of
    two: rank 0 alone logs (one histogram pass, each entry its full
    tensor's under the single process's name) and writes one process's
    weights; ``vqa_eval`` of them at dp=2 (each rank its strided shard of
    the test questions, the predictions gathered and put back in dataset
    order) and at tp=2 writes the files one process writes from the same
    weights."""
    import contextlib
    import io
    import json

    from mmvqa_tpu_torch.cli import vqa_eval
    from mmvqa_tpu_torch.train import checkpoint
    from mmvqa_tpu_torch.data.fixtures import make_vqa_fixture
    from test_torch_rank_probe import vqa_clis

    data = make_vqa_fixture(str(tmp_path / "vqa"), (3, 2, 3), seed=1,
                            image_size=(40, 30))
    flags = ["--num_vis", "5", "--cnn_encoder", "tf_efficientnetv2_m",
             "--transformer_model", "realformer", "--tiny_cnn",
             "--hidden_size", "32", "--n_layers", "1", "--image_size", "32",
             "--batch_size", "4", "--num_workers", "1",
             "--max_position_embeddings", "16"]
    run_world(vqa_clis, 2, (data, str(tmp_path), flags),
              str(tmp_path / "rendezvous"), "cpu", TIMEOUT)
    train = tmp_path / "train"
    with open(train / "p_metrics.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 2  # one epoch and its histograms, logged once
    weights = checkpoint.load_weights(str(train / "MLM" / "p"))
    model = MMBert(vqa_config(
        cnn_encoder="tf_efficientnetv2_m", transformer_model="realformer",
        tiny_cnn=True, hidden_size=32, n_layers=1, image_size=32,
        max_position_embeddings=16, num_classes=len(
            weights["classifier_2.bias"]),
        vocab_size=len(weights["bert_embedding.word_embeddings.weight"])),
        device="cpu")
    names = bridge.flax_names(model)
    want = {f"{kind}/{names[k]}": p.numel()
            for k, p in model.named_parameters() for kind in ("ghist", "whist")}
    hists = lines[1]["histograms"]
    assert {k: sum(h["counts"]) for k, h in hists.items()} == want
    single = tmp_path / "single"
    with contextlib.redirect_stdout(io.StringIO()):
        vqa_eval.main(["--run_name", "e", "--data_dir", data, "--save_dir",
                       str(single), "--model_dir",
                       str(train / "MLM" / "p"), *flags], device="cpu")
    for layout in ("dp_size", "tp_size"):
        for name in ("p_preds.csv", "p_res.txt"):
            want = (single / name).read_text()
            assert (tmp_path / layout / name).read_text() == want, (layout,
                                                                   name)
