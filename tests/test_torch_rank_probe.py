"""The functions that tests/test_torch_layouts.py, test_torch_pipeline.py
and test_torch_context.py run on spawned ranks: they import nothing of the
JAX packages, which the test modules import (a rank unpickles its function
by importing its module). No tests here."""

import numpy as np


class _Items:
    def __len__(self):
        return 9

    def __getitem__(self, i):
        return {"x": np.asarray([i], np.int32)}


def shards_and_means(rt):
    """(process_shard, all_hosts_mean of rank + 1, this rank's loader
    batches as (indices, weights)) on a dp-only mesh of the world."""
    from mmvqa_tpu_torch.core import distributed, mesh
    from mmvqa_tpu_torch.data.loader import BatchLoader

    with mesh.using(mesh.make_mesh()):
        index, count = distributed.process_shard()
        mean = distributed.all_hosts_mean(rt.rank + 1.0)
        batches = [(b["x"][:, 0].tolist(), b["weights"].tolist(),
                    b["index"].tolist())
                   for b in BatchLoader(_Items(), 2, shard_index=index,
                                        shard_count=count, num_workers=1)]
    return index, count, mean, batches


def small_jobs(rt, jobs):
    """``world.run_jobs`` with FSDP over every leaf of two or more
    dimensions: the tiny models' leaves all lie below the rule's 2**15
    elements (tests/test_fsdp.py patches the JAX module the same way)."""
    from mmvqa_tpu_torch.parallel import sharding
    from mmvqa_tpu_torch.parallel.world import run_jobs

    saved = sharding.FSDP_MIN_SIZE
    sharding.FSDP_MIN_SIZE = 0
    try:
        return run_jobs(rt, jobs)
    finally:
        sharding.FSDP_MIN_SIZE = saved


def jobs_and_shards(rt, jobs):
    """``small_jobs`` and ``shards_and_means`` in one world (its start-up
    paid once)."""
    return small_jobs(rt, jobs), shards_and_means(rt)


def vqa_clis(rt, data, base, flags):
    """``vqa_train`` at dp=2 with FSDP for one epoch with its histogram
    pass (``--watch_histograms``), then ``vqa_eval`` of its weights at dp=2
    and at tp=2, each rank a CLI process would be."""
    import os

    from mmvqa_tpu_torch.cli import vqa_eval, vqa_train

    save = os.path.join(base, "train")
    vqa_train.main(["--run_name", "p", "--data_dir", data, "--save_dir",
                    save, "--epochs", "1", "--lr", "1e-3", "--dp_size", "2",
                    "--fsdp", "--watch_histograms", *flags], device="cpu")
    weights = os.path.join(save, "MLM", "p")
    for layout in (["--dp_size", "2"], ["--tp_size", "2"]):
        vqa_eval.main(["--run_name", "e", "--data_dir", data, "--save_dir",
                       os.path.join(base, layout[0][2:]), "--model_dir",
                       weights, *layout, *flags], device="cpu")


def encoder_probe(rt, case):
    """A pipelined encoder (``case``: 'kind' 'bert' or 'realformer', its
    constructor's ``kw``, the full stacked ``state``, the global input
    ``h``, ``mask`` and output cotangent ``cot``; a dropout ``seed``) on a
    (dp, 1, 1, pp) mesh of the world, placed by ``parallel.sharding.Layout``
    (each stage its rows, the dropout stream folded by data rank): its
    output gathered over 'data', the input's gradient
    (stage 0) and the parameters' gradients, stacked ones gathered over
    'pipe', all summed over 'data' (shared norms over 'pipe' too), as one
    process holds them; and whether point-to-point exchanges staged
    anything (the CPU stages nothing)."""
    import torch

    from mmvqa_tpu_torch.core import distributed, mesh
    from mmvqa_tpu_torch.models.layers import DropoutRng
    from mmvqa_tpu_torch.parallel import comm, pipeline, sharding

    dp, pp = case["dp"], case["pp"]
    spec = mesh.make_mesh(dp, 1, 1, pp)
    with mesh.using(spec):
        cls = (pipeline.PipelinedBertEncoder if case["kind"] == "bert"
               else pipeline.PipelinedRealFormerEncoder)
        rng = DropoutRng(case.get("seed", 0))
        enc = cls(rng=rng, **case["kw"])
        enc.load_state_dict({k: torch.as_tensor(v)
                             for k, v in case["state"].items()})
        enc.dropout_rng = rng
        sharding.Layout(enc, spec)
        rows = slice(*(len(case["h"]) // dp * (spec.data_rank + i)
                       for i in (0, 1)))
        h = torch.as_tensor(case["h"][rows]).requires_grad_()
        mask = torch.as_tensor(case["mask"][rows])
        staged = dict(distributed.STAGED)
        out = enc(h, mask)
        (out * torch.as_tensor(case["cot"][rows])).sum().backward()
        grads = {}
        for name, t in enc.named_parameters():
            g = torch.zeros_like(t) if t.grad is None else t.grad
            if "pp_layers" in name:
                g = comm.gather_over(g, mesh.PIPE_AXIS, 0)
            else:
                g = comm.sum_over(g, mesh.PIPE_AXIS)
            grads[name] = comm.sum_over(g, mesh.DATA_AXIS)
        dh = h.grad if h.grad is not None else torch.zeros_like(h)
        return {"out": comm.gather_over(out.detach(), mesh.DATA_AXIS, 0),
                "dh": comm.gather_over(comm.sum_over(dh, mesh.PIPE_AXIS),
                                       mesh.DATA_AXIS, 0),
                "grads": grads, "coords": spec.coords,
                "staged": distributed.STAGED["calls"] - staged["calls"]}


def pipeline_ranks(rt, jobs, cases):
    """``small_jobs`` and ``encoder_probe`` of each case in one world."""
    return small_jobs(rt, jobs), [encoder_probe(rt, c) for c in cases]


def ring_probe(rt, case):
    """A ring core over the world's context group (a (1, 1, cp, 1) mesh):
    ``case`` 'core' ('vanilla' or 'realformer'), the global q, k, v (and
    prev, the mask, the cotangents), 'vjp', dropout's 'rate' and 'seed'
    (with 'all_keep', every keep draw is True: the normalisation alone);
    returns the output (and the carry) and the gradients of q, k, v (and
    prev) gathered along T, as one process holds them."""
    import torch

    from mmvqa_tpu_torch.core import mesh
    from mmvqa_tpu_torch.ops import ring_attention
    from mmvqa_tpu_torch.parallel import comm

    spec = mesh.make_mesh(1, 1, rt.world_size, 1)
    cp, c = spec.context_size, spec.context_rank
    saved = ring_attention._keep
    if case.get("all_keep"):
        ring_attention._keep = lambda shape, rate, seed, device: torch.ones(
            shape, dtype=torch.bool, device=device)
    try:
        with mesh.using(spec):
            return _ring_case(case, cp, c, torch, ring_attention, comm, mesh)
    finally:
        ring_attention._keep = saved


def _ring_case(case, cp, c, torch, ring_attention, comm, mesh):
    vanilla = case["core"] == "vanilla"
    t_dim = 2 if vanilla else 1  # (b, h, t, d) or (b, t, h, e)

    def mine(a, dim):
        if a is None:
            return None
        t = torch.as_tensor(a)
        n = t.shape[dim] // cp
        return t.narrow(dim, c * n, n).contiguous()

    q, k, v = (mine(case[x], t_dim).requires_grad_() for x in "qkv")
    mask = mine(case.get("mask"), 1)
    ctx = mesh.CONTEXT_AXIS
    out = {}
    if vanilla:
        gen = (torch.Generator().manual_seed(case["seed"])
               if case.get("rate") else None)
        y = ring_attention.ring_vanilla_attention(
            q, k, v, mask, dropout_rng=gen,
            dropout_rate=case.get("rate", 0.0),
            deterministic=not case.get("rate"), vjp=case.get("vjp", "flash"))
        loss = (y * mine(case["cot"], 2)).sum()
        out["out"] = comm.gather_over(y.detach(), ctx, 2)
        leaves = {"q": q, "k": k, "v": v}
    else:
        prev = mine(case.get("prev"), 2)
        if prev is not None:
            prev.requires_grad_()
        y, scores = ring_attention.ring_realformer_attention(q, k, v, prev,
                                                             mask)
        loss = ((y * mine(case["cot"], 1)).sum()
                + (scores * mine(case["cot_scores"], 2)).sum())
        out["out"] = comm.gather_over(y.detach(), ctx, 1)
        out["scores"] = comm.gather_over(scores.detach(), ctx, 2)
        leaves = {"q": q, "k": k, "v": v, "prev": prev}
    loss.backward()
    for name, t in leaves.items():
        if t is not None:
            out["d" + name] = comm.gather_over(
                t.grad, ctx, 2 if name == "prev" or vanilla else 1)
    return out


def context_ranks(rt, jobs, cases, bad_ring_cfg):
    """``small_jobs``, ``ring_probe`` of each case, and what
    ``cli.common.setup_runtime`` says of ``bad_ring_cfg`` (a ring whose
    sequence does not divide over the world's context ranks)."""
    from mmvqa_tpu_torch.cli import common
    from mmvqa_tpu_torch.core import mesh

    rings = [ring_probe(rt, c) for c in cases]
    try:
        common.setup_runtime(bad_ring_cfg, "cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    finally:
        mesh.set_current(None)
    return small_jobs(rt, jobs), rings, refused
