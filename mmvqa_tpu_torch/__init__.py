"""mmvqa_tpu_torch: the PyTorch + CUDA port of mmvqa_tpu, for NVIDIA Hopper.

Modules mirror mmvqa_tpu's names. This package imports torch and never jax,
flax or mmvqa_tpu; the JAX package stays the numerical reference, and the
tests (tests/test_torch_*.py) hold each ported module against it.

Ported so far, for EfficientNetV2 + RealFormer: VQA-Med inference
(``train.steps.make_vqa_eval_step``), ROCO MLM pretraining
(``train.steps.make_mlm_steps``, ``train.state``, ``train.trainer``) and
VQA-Med fine-tuning (``train.steps.make_vqa_steps``, ``train.checkpoint``,
``train.plateau``, ``train.category_smoothing``, ``trainer.vqa_epoch``), with
hand-written CUDA kernels, forward and backward, for the visual-token head
(``ops.token_head``) and the RealFormer attention core (``ops.attention``),
built from ``csrc/`` on first use (``native.loader``). ROCO pretraining runs
from disk through ``cli.roco_train`` on the host data layer (``data.tokenizer``,
``data.jpeg``, ``data.images``, ``data.datasets``, ``data.loader``), which
needs neither pandas nor PIL; its C++ sources (``native/*.cpp``) are built
with the host's compiler on first use. Models are built on the CUDA card
unless the caller names another device.
"""
