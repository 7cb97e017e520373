"""The port's copy of Config against the JAX package's, the port's import
boundary, and its refusal to fall back to the CPU where a kernel was asked
for."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from mmvqa_tpu.core import config as jax_config

from mmvqa_tpu_torch.core import config
from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops import attention, token_head

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    def default(f):
        if f.default_factory is not dataclasses.MISSING:
            return f.default_factory()
        return f.default

    return [(f.name, f.type, default(f)) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_equal_the_jax_ones():
    assert _fields(config.Config) == _fields(jax_config.Config)


@pytest.mark.parametrize("factory", ["vqa_config", "pretrain_config",
                                     "supcon_config"])
def test_presets_equal_the_jax_ones(factory):
    port, ref = getattr(config, factory)(), getattr(jax_config, factory)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    kw = dict(hidden_size=64, n_layers=2, num_classes=7, loss="ASLSingleLabel",
              transformer_model="realformer")
    port, ref = getattr(config, factory)(**kw), getattr(jax_config, factory)(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.head_count == ref.head_count


@pytest.mark.parametrize("kw", [
    dict(hidden_size=60, transformer_model="realformer"),
    dict(hidden_size=16, transformer_model="transformer"),
    dict(transformer_model="lstm"),
    dict(grad_accum=0),
    dict(pp_size=2, transformer_model="feedback-transformer"),
    dict(pp_size=2, tp_size=2),
    dict(pp_size=3, n_layers=4),
])
def test_validate_refuses_what_the_jax_config_refuses(kw):
    with pytest.raises(ValueError) as ref:
        jax_config.vqa_config(**kw)
    with pytest.raises(ValueError) as port:
        config.vqa_config(**kw)
    assert str(port.value) == str(ref.value)


def test_port_never_imports_jax():
    """Importing the port and running a tiny forward leaves jax, flax and
    mmvqa_tpu out of sys.modules."""
    code = """
import sys
import numpy as np
import mmvqa_tpu_torch.bridge, mmvqa_tpu_torch.native.loader
import mmvqa_tpu_torch.models.feedback, mmvqa_tpu_torch.models.img_only
import mmvqa_tpu_torch.models.supcon_encoder
from mmvqa_tpu_torch.core.config import vqa_config
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.train.steps import make_vqa_eval_step
cfg = vqa_config(cnn_encoder="tf_efficientnetv2_m",
                 transformer_model="realformer", hidden_size=64, n_layers=2,
                 tiny_cnn=True, image_size=32, num_classes=4)
T = cfg.max_position_embeddings
batch = {"image": np.zeros((2, 32, 32, 3), np.uint8),
         "tokens": np.ones((2, T), np.int32),
         "segment_ids": np.zeros((2, T), np.int32),
         "input_mask": np.ones((2, T), np.float32),
         "answer": np.zeros(2, np.int32), "weights": np.ones(2, np.float32)}
out = make_vqa_eval_step(MMBert(cfg, device="cpu"), cfg)(batch)
assert out["logits"].shape == (2, 4)
print("FORBIDDEN", sorted(m for m in sys.modules
      if m.split(".")[0] in ("jax", "jaxlib", "flax", "mmvqa_tpu")))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_kernel_request_off_the_cpu_raises_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises: the
    plain version is never taken for it, and no launch is counted."""
    x = torch.zeros(2, 8, 4, device="meta")
    w = torch.zeros(4, 16, device="meta")
    before = token_head.fused_token_head.launches
    with pytest.raises(ValueError, match="not on a CUDA device"):
        token_head.fused_token_head(x, w, "serf")
    assert token_head.fused_token_head.launches == before

    q = torch.zeros(2, 8, 2, 4, device="meta")
    before = attention.realformer_attention.launches
    with pytest.raises(ValueError, match="not on a CUDA device"):
        attention.realformer_attention(q, q, q, None, None)
    assert attention.realformer_attention.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no library: the loader raises rather than falling
    back (mmvqa_tpu/native/loader.py falls back; this one must not)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(loader, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        loader.build()


def test_failed_launch_code_raises(monkeypatch):
    class _Lib:
        @staticmethod
        def mmvqa_error_string(code):
            return b"too many resources requested for launch"

    monkeypatch.setattr(loader, "library", lambda: _Lib())
    loader.check(0, "token_head_fwd")
    with pytest.raises(RuntimeError, match="token_head_fwd: CUDA error 701"):
        loader.check(701, "token_head_fwd")


def test_build_hash_covers_every_source_and_the_flags():
    names = {os.path.basename(p) for p in loader.sources()}
    assert {"common.cuh", "token_head.cu", "realformer_attention.cu"} <= names
    assert "arch=compute_90a,code=sm_90a" in loader.NVCC_FLAGS
    assert len(loader.source_hash()) == 16
