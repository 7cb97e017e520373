"""Observability: pluggable metric sink + seeding (counterpart of
mmvqa_tpu/utils/logging.py).

The reference logs per-epoch metrics to wandb with fixed key names
(roco_train.py:174-185, train.py:236-250). The sink keeps those exact key
names, always writes JSONL + stdout, and forwards to wandb when the package
exists and --wandb is on (wandb is optional here; SURVEY.md §5.5).
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    """(vqamed2019/utils.py:26-34): Python's, numpy's and torch's global
    generators. The port's own randomness (dropout, augmentation, weights)
    comes from generators seeded with ``cfg.seed`` and does not read these."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _rank() -> int:
    import torch.distributed as dist

    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


class MetricSink:
    def __init__(
        self,
        run_name: str,
        save_dir: str,
        use_wandb: bool = True,
        project: str = "medvqa",
        config: Optional[Dict] = None,
    ):
        self.run_name = run_name
        self.jsonl_path = os.path.join(save_dir, f"{run_name}_metrics.jsonl")
        self._wandb = None
        # under a layout rank 0 alone logs (mmvqa_tpu_torch/cli/common.py)
        self.enabled = _rank() == 0
        if self.enabled:
            os.makedirs(save_dir, exist_ok=True)
        if use_wandb and self.enabled:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, name=run_name, config=config)
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        rec = {"ts": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics)

    def log_histograms(self, hists: Dict, step: Optional[int] = None) -> None:
        """Per-parameter histograms {name: (counts[bins], lo, hi)} —
        the --watch_histograms payload (wandb.watch(model, log='all')
        fidelity, roco_train.py:80). JSONL gets compact count lists;
        wandb gets native Histogram objects."""
        if not self.enabled:
            return
        rec = {}
        wlog = {}
        for name, (counts, lo, hi) in hists.items():
            counts = np.asarray(counts)
            lo, hi = float(lo), float(hi)
            rec[name] = {"counts": counts.tolist(), "lo": lo, "hi": hi}
            if self._wandb is not None:
                edges = np.linspace(lo, hi, len(counts) + 1)
                wlog[name] = self._wandb.Histogram(
                    np_histogram=(counts, edges)
                )
        out = {"ts": time.time(), "histograms": rec}
        if step is not None:
            out["step"] = step
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(out) + "\n")
        if self._wandb is not None:
            self._wandb.log(wlog)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
