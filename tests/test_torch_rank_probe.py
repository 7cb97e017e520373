"""The functions that tests/test_torch_layouts.py runs on spawned ranks:
they import nothing of the JAX packages, which the test module imports
(a rank unpickles its function by importing its module). No tests here."""

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
    """``vqa_train`` at dp=2 with FSDP for one epoch, then ``vqa_eval`` of
    its weights at dp=2 and at tp=2, each rank a CLI process would be."""
    import os

    from mmvqa_tpu_torch.cli import vqa_eval, vqa_train

    save = os.path.join(base, "train")
    vqa_train.main(["--run_name", "p", "--data_dir", data, "--save_dir",
                    save, "--epochs", "1", "--lr", "1e-3", "--dp_size", "2",
                    "--fsdp", *flags], device="cpu")
    weights = os.path.join(save, "MLM", "p")
    for layout in (["--dp_size", "2"], ["--tp_size", "2"]):
        vqa_eval.main(["--run_name", "e", "--data_dir", data, "--save_dir",
                       os.path.join(base, layout[0][2:]), "--model_dir",
                       weights, *layout, *flags], device="cpu")
