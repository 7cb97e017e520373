"""Spawned worlds of ranks on one host, and the train step under a layout
that the CPU tests and the card's smoke hold to the single process.

``run_world(fn, world_size, args, init_file, device)`` starts
``world_size`` processes (start method ``spawn``), each joined to a
``torch.distributed`` world by a ``file://`` rendezvous (no port to agree
on), calls ``fn(runtime, *args)`` in each and returns the ranks' results in
rank order (``start_world`` returns at once, for worlds that run side by
side). A rank's exception comes back as an error naming the rank; the
world is joined with one timeout, after which every rank still running is
killed. Build the kernels before calling it: the ranks then only load
``_build/<hash>/`` (``native/loader.py``).

``layout_step(runtime, job)`` builds the job's model on the rank's device,
places it (``parallel.sharding.Layout``), runs one train step of the job's
kind on the rank's rows of the job's global batch, and returns the loss, the
reduced gradients, their global norm and the state after the step as one
process holds them (rank 0), a digest of them (every rank, for equality
across ranks), the shapes each kernel site ran at and the kernels' launch
counts. ``update_problems`` holds the step's change of the parameters to
the single process's.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               backend: Optional[str], threads: int, fn: Callable,
               args_path: str, results) -> None:
    try:
        import pickle

        from mmvqa_tpu_torch.core.distributed import init_from_env

        with open(args_path, "rb") as f:
            args = pickle.load(f)
        torch.set_num_threads(threads)
        # the port's fp32 is fp32 (cli/common.py::setup_runtime)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rt = init_from_env(device=device, init_method=init_method, rank=rank,
                           world_size=world_size,
                           local_world_size=world_size, backend=backend)
        out = _host(fn(rt, *args))
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - sent to the parent as text
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _host(tree):
    """Tensors as numpy arrays (a queue would pass tensors by shared memory
    that dies with the rank)."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


class World:
    """Ranks started by ``start_world``; ``results`` waits for them."""

    def __init__(self, fn: Callable, world_size: int, args: Sequence,
                 init_file: str, device: str, backend: Optional[str],
                 threads: int):
        import pickle

        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.size = world_size
        self.queue = ctx.Queue()
        self._got: Dict[int, Any] = {}  # results read by ``wait_done``
        init_method = "file://" + os.path.abspath(init_file)
        # the arguments go by file: a start would otherwise wait for its
        # rank to read them from the pipe, one rank's start-up after another
        args_path = os.path.abspath(init_file) + ".args"
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world_size, init_method, device,
                                        backend, threads, fn, args_path,
                                        self.queue), daemon=True)
                      for r in range(world_size)]
        for p in self.procs:
            p.start()

    def wait_done(self) -> None:
        """Wait until every rank has sent its result or ended (the results
        stay queued for ``results``)."""
        while len(self._got) < self.size:
            if all(p.exitcode is not None for p in self.procs):
                return
            try:
                rank, ok, out = self.queue.get(timeout=5.0)
            except queue_mod.Empty:
                continue
            self._got[rank] = (ok, out)

    def results(self, timeout: float) -> List[Any]:
        """The ranks' results in rank order; raises on a rank's error, a
        rank's death or the timeout, and stops every rank in any case."""
        got: Dict[int, Any] = {}
        for rank, (ok, out) in self._got.items():
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        deadline = time.monotonic() + timeout
        try:
            while len(got) < self.size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {self.size}: ranks "
                        f"{sorted(set(range(self.size)) - set(got))} still "
                        f"running after {timeout} s")
                try:
                    rank, ok, out = self.queue.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{self.procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for p in self.procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [got[r] for r in range(self.size)]


def start_world(fn: Callable, world_size: int, args: Sequence,
                init_file: str, device: str = "cpu",
                backend: Optional[str] = None, threads: int = 1) -> World:
    """Start ``fn(runtime, *args)`` on each of ``world_size`` spawned
    ranks, each with ``threads`` torch threads, and return at once.
    ``backend`` overrides ``init_from_env``'s rule (and makes a group of
    one rank)."""
    return World(fn, world_size, args, init_file, device, backend, threads)


def run_world(fn: Callable, world_size: int, args: Sequence, init_file: str,
              device: str = "cpu", timeout: float = 300.0,
              backend: Optional[str] = None,
              threads: int = 1) -> List[Any]:
    """``start_world`` and wait: the results in rank order, their tensors
    as numpy arrays."""
    return start_world(fn, world_size, args, init_file, device, backend,
                       threads).results(timeout)


# ---------------------------------------------------------------------------


class _Sites:
    """Records the shapes each kernel site is called at, by wrapping the
    names the models call (the kernels' own counters count launches)."""

    def __init__(self):
        from mmvqa_tpu_torch.models import (
            effnetv2,
            feedback,
            realformer,
            visual_tokens,
        )

        self.seen: Dict[str, List[tuple]] = {"K1": [], "K2": [], "K3": [],
                                             "K4": [], "memory": []}
        self._undo = []

        def wrap(mod, name, key, shape_of):
            orig = getattr(mod, name)

            def wrapped(*a, **k):
                self.seen[key].append(shape_of(*a))
                return orig(*a, **k)

            setattr(mod, name, wrapped)
            self._undo.append((mod, name, orig))

        wrap(visual_tokens, "fused_token_head", "K1",
             lambda x, w, act: (tuple(x.shape), tuple(w.shape)))
        wrap(realformer, "realformer_attention_packed", "K2",
             lambda kqv, prev, mask: tuple(kqv.shape))
        wrap(effnetv2, "depthwise3x3", "K3", lambda x, w: tuple(x.shape))
        wrap(effnetv2, "conv1x1_stats", "K4",
             lambda x, w: (tuple(x.shape), tuple(w.shape)))
        # the feedback encoder's memory of keys a window reads
        wrap(feedback.FeedbackSegment, "forward", "memory",
             lambda seg, mem_k, *a: tuple(mem_k.shape))

    def close(self) -> Dict[str, List[tuple]]:
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)
        return self.seen


def counters():
    """(name, wrapper, attribute) of every launch counter of the five
    kernels, forward and backward, and of their tensor-core paths, by the
    names of the smoke's summary."""
    from mmvqa_tpu_torch.ops.attention import realformer_attention as k2
    from mmvqa_tpu_torch.ops.bn_sums import bn_backward_sums as k5
    from mmvqa_tpu_torch.ops.conv_bn import conv1x1_stats as k4
    from mmvqa_tpu_torch.ops.depthwise import depthwise3x3 as k3
    from mmvqa_tpu_torch.ops.token_head import fused_token_head as k1

    return (("token_head", k1, "launches"),
            ("token_head_tf32x3", k1, "tf32x3_launches"),
            ("token_head_bwd", k1, "backward_launches"),
            ("token_head_bwd_tf32x3", k1, "backward_tf32x3_launches"),
            ("realformer_attention", k2, "launches"),
            ("realformer_attention_mma", k2, "mma_launches"),
            ("realformer_attention_tf32x3", k2, "tf32x3_launches"),
            ("realformer_attention_bwd", k2, "backward_launches"),
            ("realformer_attention_bwd_mma", k2, "backward_mma_launches"),
            ("realformer_attention_bwd_tf32x3", k2,
             "backward_tf32x3_launches"),
            ("depthwise3x3", k3, "launches"),
            ("depthwise3x3_bwd", k3, "backward_launches"),
            ("conv1x1_stats", k4, "launches"),
            ("conv1x1_stats_tma", k4, "tma_launches"),
            ("conv1x1_stats_tf32x3", k4, "tf32x3_launches"),
            ("bn_backward_sums", k5, "launches"))


def kernel_counts() -> Dict[str, int]:
    """Every launch counter's value, by name (``counters``)."""
    return {name: getattr(fn, attr) for name, fn, attr in counters()}


def collectives_probe(rt) -> Dict:
    """The three collectives once each on a CUDA tensor of this rank's card
    over the world, against their arithmetic; returns the backend and what
    was staged through host memory (NCCL: nothing)."""
    import torch.distributed as dist

    from mmvqa_tpu_torch.core import distributed

    n, r = dist.get_world_size(), dist.get_rank()
    world = dist.group.WORLD
    before = dict(distributed.STAGED)
    t = torch.full((4,), float(r + 1), device=rt.device)
    distributed.all_reduce(t, world)
    out = torch.empty(4 * n, device=rt.device)
    distributed.all_gather_into_tensor(
        out, torch.arange(4, device=rt.device, dtype=torch.float32) + 10 * r,
        world)
    part = torch.empty(4, device=rt.device)
    distributed.reduce_scatter_tensor(
        part, torch.arange(4 * n, device=rt.device, dtype=torch.float32),
        world)
    want_sum = n * (n + 1) / 2
    ok = (bool((t == want_sum).all())
          and out.tolist() == [10.0 * q + i for q in range(n)
                               for i in range(4)]
          and part.tolist() == [float(n * (4 * r + i)) for i in range(4)])
    return {"backend": dist.get_backend(), "ok": ok,
            "staged_calls": distributed.STAGED["calls"] - before["calls"],
            "staged_bytes": distributed.STAGED["bytes"] - before["bytes"]}


def microbatches(job: Dict) -> int:
    """The job's GPipe microbatches M (1 without a pipeline)."""
    from mmvqa_tpu_torch.parallel.pipeline import pick_microbatches

    pp = job.get("pp", 1)
    if pp == 1:
        return 1
    rows = len(job["batch"]["weights"]) // job["dp"]
    if job["kind"] == "supcon":
        rows *= 2  # the two views
    return pick_microbatches(job["cfg"].pp_microbatches, rows, pp)


def _ring(job: Dict) -> bool:
    return job.get("cp", 1) > 1 and job["cfg"].attention_impl == "ring"


def site_problems(ref: Dict[str, List[tuple]], got: Dict[str, List[tuple]],
                  dp: int, tp: int, job: Optional[Dict] = None) -> List[str]:
    """What is wrong with a rank's kernel sites (``got``) against the single
    process's (``ref``) under (dp, tp): K1 must run on (B / dp, P, K) x
    (K, C / tp), K2 on H / tp heads of B / dp, K3 on B / dp and the local
    channels (every stride-1 depthwise site lies between a column-parallel
    ``pw_exp`` and its row-parallel ``pw_proj``), and K4 at every site at
    tp = 1 but, under tp > 1, only at the column-parallel ``pw_exp`` sites
    (those that widen, C > K) on C / tp channels. Under context parallelism
    (``job``'s cp) K2 runs at full T where the encoder gathers the sequence
    and not at all under the ring; under a pipeline (pp) each stage runs its
    L / pp layers on each of M microbatches of B / dp / M rows."""
    out = []
    job = job or {}
    pp, M = job.get("pp", 1), microbatches(job) if job else 1

    def want(name, a, b):
        if a != b:
            out.append(f"{name}: ran {a}, expected {b}")

    want("K1", got["K1"], [((x[0] // dp,) + x[1:], (w[0], w[1] // tp))
                           for x, w in ref["K1"]])
    k2 = [(k[0] // dp, k[1], k[2] // tp, k[3]) for k in ref["K2"]]
    if _ring(job):
        k2 = []
    elif pp > 1:
        k2 = [(k[0] // M,) + k[1:] for k in k2[:len(k2) // pp]] * M
    want("K2", got["K2"], k2)
    want("K3", got["K3"], [(x[0] // dp,) + x[1:3] + (x[3] // tp,)
                           for x in ref["K3"]])
    want("K4", got["K4"], [((x[0] // dp, x[1]), (w[0], w[1] // tp))
                           for x, w in ref["K4"] if tp == 1 or w[1] > w[0]])
    return out


# the counters of the trunk's backward kernels, and of K2's
TRUNK_BACKWARD = ("token_head_bwd", "token_head_bwd_tf32x3",
                  "depthwise3x3_bwd", "bn_backward_sums")


def expected_launches(ref: Dict[str, int], job: Dict,
                      coords: Sequence[int]) -> Dict[str, int]:
    """A rank's launch counts in the checked step against the single
    process's (``ref``), for the counters a context or pipe axis changes:
    the trunk runs its forward on every rank but its backward only where
    its output reaches the loss (context rank 0, stage 0); K2 runs the
    single process's launches where the encoder gathers the sequence, none
    under the ring, and M / pp of them on each stage of a pipeline."""
    _, _, c, p = coords
    out = dict(ref)
    if c or p:
        out.update({k: 0 for k in TRUNK_BACKWARD})
    pp, M = job.get("pp", 1), microbatches(job)
    for k in out:
        if k.startswith("realformer_attention"):
            out[k] = 0 if _ring(job) else out[k] * M // pp
    return out


# ``update_problems``' thresholds: Adam's eps and lr multiples
HELD_EPS = 100.0
UPDATE_TOL = 0.02


def update_problems(before: Dict, after: Dict, ref_after: Dict,
                    ref_grads: Dict, lr: float, scale: float = 1.0,
                    grad_tol: Optional[Dict[str, float]] = None):
    """The change a step made to each parameter of ``ref_grads``
    (``after - before``) against the reference's (``ref_after - before``).

    Adam's first step moves an entry by lr * s g / (s |g| + eps), with s
    the clip's ``scale``: by about lr whatever the gradient's size, so a
    state held to a multiple of lr would pass a step whose update never
    reached the parameters. The change is held to UPDATE_TOL * lr plus the
    float32 spacing of the parameter at every entry whose reference
    gradient g has s |g| >= tau = max(HELD_EPS * eps, 2 s grad_tol[k]),
    ``grad_tol`` being the tolerance the gradient itself is held to (None:
    as close as the gradients come, far below HELD_EPS * eps on the CPU).
    There a gradient g' within tau / 2 of g moves the change by at most
    lr * eps / tau <= lr / HELD_EPS. An entry closer to 0 may step either
    way: it is dropped and counted.

    Returns (problems, entries held, entries dropped)."""
    import numpy as np

    from mmvqa_tpu_torch.train.state import ADAM_EPS

    problems, held, dropped = [], 0, 0
    for k, g in ref_grads.items():
        g = np.abs(np.asarray(g, np.float64)) * scale
        w0 = np.asarray(before[k], np.float64)
        want = np.asarray(ref_after[k], np.float64) - w0
        got = np.asarray(after[k], np.float64) - w0
        tau = max(HELD_EPS * ADAM_EPS,
                  2.0 * scale * (grad_tol or {}).get(k, 0.0))
        keep = g >= tau
        lim = UPDATE_TOL * lr + np.spacing(np.maximum(
            np.abs(w0), np.abs(np.asarray(ref_after[k], np.float64))
        ).astype(np.float32)).astype(np.float64)
        bad = keep & ~(np.abs(got - want) <= lim)
        held += int(keep.sum())
        dropped += int(keep.size - keep.sum())
        if bad.any():
            i = np.flatnonzero(bad)[0]
            problems.append(
                f"{k}: {int(bad.sum())} of {int(keep.sum())} held entries "
                f"changed unlike the reference, e.g. flat entry {i}: "
                f"{got.flat[i]:.3e} against {want.flat[i]:.3e} "
                f"(lr {lr:.1e})")
    return problems, held, dropped


def _digest(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's sum of magnitudes in float64, where it lies."""
    return {k: v.double().abs().sum().item() for k, v in tensors.items()}


def make_steps(kind: str, model, cfg, aug=None):
    """The train step of ``kind`` ('mlm', 'supcon', 'vqa'), with ``aug``
    (an ``AugmentSpec``) or the step's default augmentation."""
    from mmvqa_tpu_torch.train import steps

    make = {"mlm": steps.make_mlm_steps, "supcon": steps.make_supcon_steps,
            "vqa": steps.make_vqa_steps}[kind]
    return (make(model, cfg) if aug is None else make(model, cfg, aug))[0]


def run_jobs(rt, jobs: Sequence[Dict]) -> List[Dict]:
    """``layout_step`` of each job in turn, in one world (a world's start-up
    is paid once); each result also says whether the rank imported any of
    the JAX packages (it must not)."""
    import sys

    out = []
    for job in jobs:
        out.append(layout_step(rt, job))
        if rt.device.type == "cuda":  # the card is shared with other ranks
            torch.cuda.empty_cache()
    jax_modules = [m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "mmvqa_tpu")]
    for o in out:
        o["jax_modules"] = jax_modules
    return out


def single_step(job: Dict, device) -> Dict:
    """The job's step in this process, without a mesh: the reference a
    layout is held to (``layout_step`` with dp = tp = 1)."""
    from mmvqa_tpu_torch.core import mesh
    from mmvqa_tpu_torch.core.distributed import Runtime

    with mesh.using(None):
        return layout_step(Runtime(0, 1, 0, torch.device(device), None),
                           dict(job, dp=1, tp=1, cp=1, pp=1, fsdp=False))


def layout_step(rt, job: Dict) -> Dict:
    """One train step of ``job`` on this rank; see the module docstring.

    ``job``: ``cfg`` (the port's Config; the model is the one it seeds),
    ``kind`` ('mlm', 'supcon', 'vqa'), ``dp``, ``tp``, ``cp`` and ``pp``
    (1 where absent), ``fsdp``, ``batch``
    (the global batch, numpy), ``clip``, ``lr``, ``aug`` (an
    ``AugmentSpec``, None for the step's default; the draws come from the
    step's own generator), ``keep`` (the state dict keys whose tensors and
    gradients come back, the largest as ``_rows`` of them; None for all),
    ``bn3_scale`` (every bn3 scale multiplied by it, the card checks'
    conditioning of a deep trunk), ``timed`` (on a card, a second step,
    profiled: its wall and busy ms), ``save_dir`` (the weights and the
    recorder saved there after the step, and the recorder restored),
    ``hist`` (the ``--watch_histograms`` pass before the step, as ``hist``,
    and again after it; ``hist_kept_state`` says whether both left every
    tensor, gradient and dropout stream of the rank as it was),
    ``resume_dir`` (the recorder saved there after the step, restored into
    a new model, layout and state, and a second step taken: its loss, the
    state after it and, in the single process, its gradients; and whether
    the same step on the saved state in memory gave the same loss and
    state, bit for bit).

    The single process (no layout) also returns ``before``, its kept
    parameters before the step: every layout starts from the same seeded
    model. ``grad_norm`` is the global norm of the reduced gradient
    (``Layout.global_norm`` under a layout), ``clip_norm`` the norm the
    clip measured (with ``clip``). Under a layout ``rest_problems`` lists
    what the placed model holds at rest beyond its blocks
    (``Layout.rest_problems``) and ``fsdp_leaves`` each FSDP leaf's
    elements on the rank beside its full count; on a card ``rest_bytes``
    is what the rank holds after the step (parameters, Adam's moments)."""
    from mmvqa_tpu_torch.core import distributed, mesh
    from mmvqa_tpu_torch.parallel import sharding
    from mmvqa_tpu_torch.train.state import create_train_state

    t_setup = time.perf_counter()
    cfg = job["cfg"]
    spec = (mesh.make_mesh(job["dp"], job["tp"], job.get("cp", 1),
                           job.get("pp", 1))
            if rt.world_size > 1 else mesh.MeshSpec(1, 1))
    dev = rt.device
    with mesh.using(spec if rt.world_size > 1 else None):
        model = _seeded_model(cfg)
        if job.get("bn3_scale") is not None:
            with torch.no_grad():
                for name, mod in model.named_modules():
                    if name.endswith(".bn3"):
                        mod.weight.mul_(job["bn3_scale"])
        model.to(dev)
        layout = (sharding.Layout(model, spec, job["fsdp"])
                  if rt.world_size > 1 else None)
        state = create_train_state(model, job.get("lr", cfg.lr),
                                   clip=job.get("clip", False),
                                   layout=layout)
        train_step = make_steps(job["kind"], model, cfg, job.get("aug"))
        batch = sharding.place_batch(job["batch"], spec)
        hist = (_hist_pass(job, model, state, batch) if job.get("hist")
                else {})
        grads: Dict[str, torch.Tensor] = {}
        norm: Dict[str, float] = {}
        keep = job.get("keep")
        start = ({} if layout is not None or rt.rank else
                 _after_step(model, None, keep, params_only=True))

        def record(named, full=lambda n, g: g):
            for n, t in named:
                if keep is not None and n not in keep:
                    continue
                g = full(n, torch.zeros_like(t) if t.grad is None else t.grad)
                grads[n] = (g if keep is None else _rows(g)).detach().cpu(
                ).clone()

        # the checked step's gradients and their norm, before the clip and
        # the update
        if layout is None:
            def capture():
                named = list(model.named_parameters())
                record(named)
                norm["grad_norm"] = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(p.grad.float())
                     for _, p in named if p.grad is not None])).item()
                type(state).apply_gradients(state)

            state.apply_gradients = capture
        else:
            def capture():
                type(layout).reduce_gradients(layout)
                opt = dict(model.named_parameters())
                record(opt.items(), layout.full)
                norm["grad_norm"] = layout.global_norm(
                    {n: t.grad for n, t in opt.items()}).item()

            layout.reduce_gradients = capture
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        setup_s = time.perf_counter() - t_setup
        sites = _Sites()
        before = kernel_counts()
        staged = dict(distributed.STAGED)
        t0 = time.perf_counter()
        _, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        if state.clip_norm is not None:
            norm["clip_norm"] = state.clip_norm.item()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        rest = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        after = kernel_counts()
        moved = {k: distributed.STAGED[k] - staged[k] for k in staged}
        seen = sites.close()
        for obj in (state, layout):
            if obj is not None:
                vars(obj).pop("apply_gradients", None)
                vars(obj).pop("reduce_gradients", None)
        t_after = time.perf_counter()
        if job.get("hist"):
            again = _hist_pass(job, model, state, batch)
            hist["hist_kept_state"] = (hist["hist_kept_state"]
                                       and again["hist_kept_state"])
        full = _after_step(model, layout, keep)
        reloaded = (_checkpoint_round_trip(state, job["save_dir"])
                    if job.get("save_dir") else {})
        timed = (_timed_step(train_step, state, batch, dev)
                 if job.get("timed") and dev.type == "cuda" else {})
        resumed = (_resumed_step(rt, job, spec, batch, state, keep)
                   if job.get("resume_dir") else {})
        out = {
            "rank": rt.rank, "coords": spec.coords, "loss": loss,
            "setup_s": setup_s,
            "digest": _digest(full) if keep is None else _digest(
                {**full, **_replicated(model, layout)}),
            "grad_digest": _digest(grads),
            "launches": {k: after[k] - before[k] for k in after},
            "sites": seen, "seconds": seconds, **timed, **reloaded,
            **hist, **resumed,
            "staged_bytes": moved["bytes"], "staged_calls": moved["calls"],
            # the step's peak above what the process held before it (the
            # model's parameters, and in a process that ran more, the rest)
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) - held
                           if dev.type == "cuda" else 0),
            "held_bytes": held if dev.type == "cuda" else 0,
            "rest_bytes": rest,
            "rest_problems": ([] if layout is None
                              else layout.rest_problems()),
            "fsdp_leaves": ({} if layout is None else {
                k: (p.numel(), layout.full_shapes[k].numel(),
                    layout.placements[k].tp_dim is not None)
                for k, p in model.named_parameters()
                if layout.fsdp_dim(k) is not None}),
            "metrics": {k: (v.cpu() if torch.is_tensor(v) else v)
                        for k, v in metrics.items()},
            **norm,
        }
        out["after_s"] = time.perf_counter() - t_after
        if rt.rank == 0:
            out["state"] = full
            out["grads"] = grads
            if layout is None:
                out["before"] = start
        else:
            out.pop("resumed_state", None)
        return out


def _snapshot(model, state) -> Dict[str, torch.Tensor]:
    """Every tensor of a rank's training state: parameters, buffers, Adam's
    moments, the gradients (a missing one as an empty tensor) and the
    dropout streams' generator states."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v).clone()
                    for k, v in st.items()})
    for k, p in model.named_parameters():
        out[f"grad.{k}"] = (torch.empty(0) if p.grad is None
                            else p.grad.detach().clone())
    seed, gens = model.dropout_rng.get_state()
    out["rng.seed"] = torch.tensor(seed)
    out.update({f"rng.{d}": g for d, g in gens.items()})
    return out


def _hist_pass(job: Dict, model, state, batch) -> Dict:
    """``cli.common.make_hist_logger``'s pass (epoch 0) on this rank's part
    of the job's batch: the histograms, and whether the rank's state came
    out as it went in."""
    from mmvqa_tpu_torch.cli.common import make_hist_logger
    from mmvqa_tpu_torch.data.images import FINETUNE_AUG, PRETRAIN_AUG

    cfg = job["cfg"].replace(watch_histograms=True)
    aug = job.get("aug") or (FINETUNE_AUG if job["kind"] == "vqa"
                             else PRETRAIN_AUG)
    before = _snapshot(model, state)
    hists = make_hist_logger(cfg, model, aug, batch, job["kind"],
                             layout=state.layout)(0)
    after = _snapshot(model, state)
    kept = before.keys() == after.keys() and all(
        torch.equal(before[k], after[k]) for k in before)
    return {"hist": hists, "hist_kept_state": kept}


def _resumed_step(rt, job: Dict, spec, batch, state, keep) -> Dict:
    """Save the recorder after the checked step, restore it into a new
    model, layout and train state, and take a second step there."""
    from mmvqa_tpu_torch.parallel import sharding
    from mmvqa_tpu_torch.train import checkpoint
    from mmvqa_tpu_torch.train.state import create_train_state

    layout = state.layout
    path = os.path.join(job["resume_dir"],
                        "single" if layout is None else "layout")
    checkpoint.save_recorder(path, 0, state, {"lr": state.lr})
    model = _seeded_model(job["cfg"]).to(rt.device)
    placed = (None if layout is None
              else sharding.Layout(model, spec, layout.fsdp))
    resumed = create_train_state(model, job.get("lr", job["cfg"].lr),
                                 clip=job.get("clip", False), layout=placed)
    resumed, _, _ = checkpoint.restore_recorder(path, resumed)
    grads: Dict[str, torch.Tensor] = {}
    if placed is None:
        def capture():
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None})
            type(resumed).apply_gradients(resumed)

        resumed.apply_gradients = capture
    _, metrics = make_steps(job["kind"], model, job["cfg"],
                            job.get("aug"))(resumed, batch)
    vars(resumed).pop("apply_gradients", None)
    # the same second step on the state that was saved, in memory
    _, kept = make_steps(job["kind"], state.model, job["cfg"],
                         job.get("aug"))(state, batch)
    mine = _digest(model.state_dict())
    out = {"resumed_loss": float(metrics["loss"]),
           "resumed_as_kept": (float(kept["loss"]) == float(metrics["loss"])
                               and mine == _digest(state.model.state_dict())),
           "resumed_adam_steps": [int(st["step"]) for st in
                                  resumed.optimizer.state_dict()[
                                      "state"].values()][:1],
           "resumed_state": _after_step(model, placed, keep)}
    if placed is None:
        out["resumed_grads"] = grads
    return out


_MODELS: Dict[Any, Any] = {}


def _seeded_model(cfg):
    """A copy of the model ``cfg`` seeds, on the CPU (built once a process
    and configuration: the jobs of a world share a few)."""
    import copy

    from mmvqa_tpu_torch.models import MMBert

    key = repr(cfg)
    if key not in _MODELS:
        _MODELS.clear()  # one full-size model at a time
        _MODELS[key] = MMBert(cfg, device="cpu")
    return copy.deepcopy(_MODELS[key])


# a kept tensor above this many elements comes back as its first and last
# KEEP_ROWS rows (in the first and the last model rank's blocks): the
# vocabulary's tables are 94 MB each at full width
KEEP_ELEMENTS = 2 ** 22
KEEP_ROWS = 2048


def _rows(t: torch.Tensor) -> torch.Tensor:
    if t.numel() <= KEEP_ELEMENTS or t.shape[0] <= 2 * KEEP_ROWS:
        return t
    return torch.cat([t[:KEEP_ROWS], t[-KEEP_ROWS:]])


def _after_step(model, layout, keep,
                params_only: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict after the step as one process holds it (collective
    under a layout): every entry, or those in ``keep`` (``_rows`` of
    each); with ``params_only``, the parameters among them."""
    local = model.state_dict()
    if params_only:
        local = dict(model.named_parameters())
    names = list(local) if keep is None else [k for k in keep if k in local]
    out = {}
    for k in names:
        v = local[k]
        if layout is not None and k in layout.placements:
            v = layout.full(k, v)
        out[k] = (v if keep is None else _rows(v)).detach().cpu().clone()
    return out


def _replicated(model, layout) -> Dict[str, torch.Tensor]:
    """This rank's entries that every rank holds whole (each must be equal
    on every rank): all but the tensor-parallel, the pipe and the FSDP
    blocks."""
    return {k: v.detach() for k, v in model.state_dict().items()
            if layout is None or k not in layout.placements
            or (layout.placements[k].tp_dim is None
                and layout.placements[k].pipe_dim is None
                and layout.fsdp_dim(k) is None)}


def _checkpoint_round_trip(state, save_dir: str) -> Dict:
    """Save the weights and the recorder (rank 0 writes, every rank
    gathers), restore the recorder into the state, and say whether every
    rank's tensors came back as they were."""
    from mmvqa_tpu_torch.train import checkpoint

    def tensors():
        out = dict(state.model.state_dict())
        for i, st in state.optimizer.state_dict()["state"].items():
            out.update({f"adam.{i}.{k}": v for k, v in st.items()})
        return {k: v.detach().clone() for k, v in out.items()}

    before = tensors()
    checkpoint.save_weights(os.path.join(save_dir, "weights"), state)
    checkpoint.save_recorder(save_dir, 0, state, {"lr": state.lr})
    checkpoint.restore_recorder(save_dir, state)
    after = tensors()
    return {"reloaded_equal": before.keys() == after.keys() and all(
        torch.equal(before[k].cpu(), after[k].cpu()) for k in before)}


def _timed_step(train_step, state, batch, dev) -> Dict[str, float]:
    """A second step, after the checked one: its wall time and the card's
    busy time in it, the device time of the kernels and copies that
    torch.profiler saw (the card's activity only, which keeps the
    profiler's own cost small)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    busy = sum(a.self_device_time_total for a in prof.key_averages())
    return {"step_ms": wall * 1e3, "busy_ms": busy / 1e3}
