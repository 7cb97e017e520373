"""Unified configuration, copied field for field from mmvqa_tpu/core/config.py.

The JAX module imports no jax itself, but its package ``__init__`` does, so
the port carries its own copy; tests/test_torch_config.py holds the two to
the same fields, defaults, presets and ``validate()`` rules. Fields that only
the JAX runtime reads (mesh sizes, ``steps_per_call``, ``token_head``,
``attention_impl``...) are kept so that one config describes a run in
either package.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class Config:
    # -- run / IO ---------------------------------------------------------
    run_name: str = "run"
    data_dir: str = "roco"
    save_dir: str = "save"
    model_dir: str = ""          # weights to load for fine-tune/eval
    resume_dir: str = ""         # weights to load when resuming
    output: str = "grad_cam"     # grad-cam output path

    # -- task selection ---------------------------------------------------
    task: str = "MLM"            # 'MLM' | 'distillation'
    dataset: str = "roco"        # 'roco' | 'VQA-Med'
    category: Optional[str] = None  # optional VQA category filter

    # -- model ------------------------------------------------------------
    transformer_model: str = "transformer"  # 'transformer'|'realformer'|'feedback-transformer'
    cnn_encoder: str = "resnet152"           # 'resnet152' | 'tf_efficientnetv2_m'
    num_vis: int = 5
    hidden_size: int = 768
    n_layers: int = 4
    heads: int = 12
    vocab_size: int = 30522
    type_vocab_size: int = 2
    max_position_embeddings: int = 75
    hidden_dropout_prob: float = 0.3
    use_relu: bool = False
    feat_dim: int = 128          # SupCon projection dim (mmbert.py:130)
    num_classes: int = 0         # filled from the answer vocab at runtime
    image_size: int = 224
    grad_cam: bool = False

    # -- pretraining objective --------------------------------------------
    mlm_prob: float = 0.15
    clinicalbert: str = "emilyalsentzer/Bio_ClinicalBERT"
    max_token_length: int = 512

    # -- contrastive pretraining ------------------------------------------
    supcon: bool = False
    con_task: str = "supcon"      # 'supcon' | 'simclr'
    similarity: str = "jaccard"   # 'jaccard'|'cosine'|'sentence_transformers'|'bert_score'
    bert_score: str = "bert"      # 'bert' | 'scibert'
    # Reference quirk: the SupCon similarity mask is computed but never passed
    # to the loss (supcon_utils.py:286-287) — the live path is SimCLR-style.
    # ``use_sim_mask=True`` opts into actually using the mask (the behaviour
    # of the dead ``train_one_epoch_old`` at supcon_utils.py:386-447).
    use_sim_mask: bool = False

    # -- optimization -----------------------------------------------------
    batch_size: int = 16
    lr: float = 2e-5
    epochs: int = 10
    patience: int = 5            # ReduceLROnPlateau patience
    factor: float = 0.1          # ReduceLROnPlateau factor
    counter: int = 20            # early-stop patience (vqamed2019/train.py:56)
    clip: bool = False           # clip grad-norm at 1.0 (utils.py:655-666)
    mixed_precision: bool = False  # bf16 compute on TPU (replaces GradScaler)
    smoothing: Optional[float] = None  # label smoothing amount
    loss: str = "CrossEntropyLoss"     # 'CrossEntropyLoss' | 'ASLSingleLabel'
    seed: int = 42
    save_model_epoch: int = 4

    # -- resume -----------------------------------------------------------
    resume: bool = False
    resume_training: bool = False
    no_recorder: bool = False
    val_loss_resume: float = math.inf
    use_pretrained: bool = False

    # -- data -------------------------------------------------------------
    train_pct: float = 1.0
    valid_pct: float = 1.0
    test_pct: float = 1.0
    num_workers: int = 4
    vocab_file: str = ""         # WordPiece vocab.txt (searched in data_dir if empty)

    # -- observability ----------------------------------------------------
    wandb: bool = True
    # full wandb.watch(model, log='all') fidelity: per-parameter grad +
    # weight histograms at EPOCH END (device-side binning, tiny pull;
    # zero per-step cost — train/steps.py::grad_weight_histograms)
    watch_histograms: bool = False
    # wandb.watch(model, log='all') equivalent (roco_train.py:80): log
    # per-top-level-module gradient L2 norms from the train step
    watch: bool = False

    # -- TPU-native additions (no reference equivalent, SURVEY.md §2.9) ----
    dp_size: int = -1            # data-parallel mesh size (-1 = all devices)
    tp_size: int = 1             # tensor-parallel mesh size
    cp_size: int = 1             # context(sequence)-parallel mesh size (§5.7)
    # ZeRO-style fully-sharded data parallelism: shard params + Adam
    # moments over the 'data' axis (parallel/sharding.py FSDP rule);
    # GSPMD all-gathers weights at use and reduce-scatters grads.
    # ~1/dp per-device state memory, bit-identical math to pure DP.
    fsdp: bool = False
    # Pipeline parallelism (parallel/pipeline.py): with pp_size>1 the
    # encoder's layer stack shards over the mesh 'pipe' axis and runs a
    # GPipe microbatch schedule in shard_map (ppermute hops over ICI; the
    # realformer's residual score carry rides the same hop). Composes with
    # DP; requires transformer_model in ('transformer', 'realformer'),
    # tp_size==1, cp_size==1, n_layers % pp_size == 0.
    pp_size: int = 1
    # GPipe microbatches per data shard (0 = auto: 2*pp if it divides the
    # per-shard batch, else pp). Bubble fraction = (pp-1)/(M+pp-1).
    pp_microbatches: int = 0
    host_augment: bool = False   # force host-side augmentation (debug)
    tiny_cnn: bool = False       # 1-block-per-stage CNN trunks (tests/dryruns)
    donate: bool = True          # donate train-state buffers to the jit step
    profile_dir: str = ""        # jax.profiler trace output directory
    debug_nans: bool = False     # jax_debug_nans (SURVEY.md §5.2)
    # persistent disk-backed decoded-image cache dir ('' = off): kills the
    # recurring cold-epoch decode penalty (images.DecodedImageCache)
    image_cache_dir: str = ""
    # JAX package: chain K train/eval steps into one jit dispatch
    steps_per_call: int = 60
    # gradient accumulation: average N micro-batches into ONE optimizer
    # update (optax.MultiSteps inside the hyperparam-injected tx) —
    # effective batch = N x batch_size when the target batch exceeds HBM.
    # BN batch stats still update per micro-batch (torch-accum semantics).
    grad_accum: int = 1
    # visual-token head impl of the JAX package ('auto' routes by map size
    # on a TPU); the port sends every tap through its CUDA kernel on a card
    token_head: str = "auto"
    # attention compute core: 'auto' (XLA at reference lengths), 'xla',
    # 'pallas' (fused kernel, long-seq escape hatch), or 'ring' (blockwise
    # ring attention over the 'context' mesh axis, ops/ring_attention.py —
    # O(T/cp) per-device attention memory instead of GSPMD's all-gather)
    attention_impl: str = "auto"
    # When set, overrides EVERY dropout rate in the model (embeddings 0.1,
    # RealFormer dp1/dp2 0.1, Feedback attn/ff 0.1, BertEncoder
    # hidden_dropout_prob). Used by the offline trajectory-parity harness
    # (tests/test_trajectory_parity.py) to run the real train step
    # deterministically; None keeps the reference rates.
    dropout_override: Optional[float] = None

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def head_count(self) -> int:
        """RealFormer hard-codes 8 heads regardless of --heads (mmbert.py:100)."""
        if "realformer" in self.transformer_model:
            return 8
        return self.heads

    def validate(self) -> None:
        if self.hidden_size % self.head_count != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"{self.head_count} heads"
            )
        if self.transformer_model not in (
            "transformer",
            "realformer",
            "feedback-transformer",
        ):
            raise ValueError(f"unknown transformer_model {self.transformer_model}")
        if self.grad_accum < 1:
            raise ValueError(f"--grad_accum must be >= 1, got {self.grad_accum}")
        if self.pp_size > 1:
            if self.transformer_model not in ("transformer", "realformer"):
                raise ValueError(
                    "--pp_size > 1 supports transformer_model='transformer' "
                    f"or 'realformer' (got {self.transformer_model!r}): the "
                    "feedback-transformer's rolling memory FIFO is consumed "
                    "by every later token window (cross-layer AND "
                    "cross-position state), which breaks GPipe's "
                    "stage-local dataflow"
                )
            if self.tp_size != 1 or self.cp_size != 1:
                raise ValueError(
                    "--pp_size composes with data parallelism only (v1): "
                    f"tp_size={self.tp_size}, cp_size={self.cp_size}"
                )
            if self.n_layers % self.pp_size != 0:
                raise ValueError(
                    f"n_layers {self.n_layers} not divisible by "
                    f"pp_size {self.pp_size}"
                )


def pretrain_config(**kw: Any) -> Config:
    """Defaults of pretrain/roco_train.py:21-61."""
    base = Config(
        data_dir="roco",
        save_dir="MMBERT/pretrain/save",
        task="MLM",
        dataset="roco",
        max_position_embeddings=75,
        hidden_size=768,
        batch_size=16,
        lr=2e-5,
        patience=5,
        epochs=10,
    )
    cfg = base.replace(**kw)
    # Validate at construction, not just in cli.common.setup_runtime:
    # programmatic users (tools/perf.py, dryruns, library use) would
    # otherwise hit opaque tree/shard_map errors downstream of MMBert.
    cfg.validate()
    return cfg


def vqa_config(**kw: Any) -> Config:
    """Defaults of vqamed2019/train.py:30-81 / eval.py:25-68.

    Note the reference's fine-tune default ``hidden_size=312`` (train.py:62)
    conflicts with the 768-wide BERT embedding table it loads; real runs pass
    768. We keep 768 as the preset default and accept --hidden_size.
    """
    base = Config(
        data_dir="ImageClef-2019-VQA-Med",
        save_dir="ImageClef-2019-VQA-Med/mmbert",
        task="MLM",
        dataset="VQA-Med",
        max_position_embeddings=28,
        hidden_size=768,
        batch_size=16,
        lr=1e-4,
        patience=10,
        epochs=100,
    )
    cfg = base.replace(**kw)
    cfg.validate()  # see pretrain_config
    return cfg


def supcon_config(**kw: Any) -> Config:
    """Defaults of pretrain/roco_supcon_train.py:25-74 (supcon=True by default)."""
    base = pretrain_config(supcon=True, con_task="supcon", similarity="jaccard")
    cfg = base.replace(**kw)
    cfg.validate()  # see pretrain_config
    return cfg
