from mmvqa_tpu_torch.ops.activations import serf
from mmvqa_tpu_torch.ops.attention import (
    realformer_attention,
    realformer_attention_backward_reference,
    realformer_attention_packed,
    realformer_attention_reference,
)
from mmvqa_tpu_torch.ops.losses import masked_mlm_nll, streaming_lse
from mmvqa_tpu_torch.ops.token_head import (
    fused_token_head,
    token_head_backward_reference,
    token_head_reference,
)

__all__ = [
    "serf",
    "realformer_attention",
    "realformer_attention_backward_reference",
    "realformer_attention_packed",
    "realformer_attention_reference",
    "masked_mlm_nll",
    "streaming_lse",
    "fused_token_head",
    "token_head_backward_reference",
    "token_head_reference",
]
