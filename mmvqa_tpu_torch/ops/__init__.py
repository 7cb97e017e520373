from mmvqa_tpu_torch.ops.activations import gelu_erf, serf
from mmvqa_tpu_torch.ops.attention import (
    realformer_attention,
    realformer_attention_backward_reference,
    realformer_attention_packed,
    realformer_attention_reference,
    vanilla_attention,
)
from mmvqa_tpu_torch.ops.bn_sums import (
    bn_backward_sums,
    bn_backward_sums_reference,
)
from mmvqa_tpu_torch.ops.conv_bn import (
    conv1x1_stats,
    conv1x1_stats_reference,
)
from mmvqa_tpu_torch.ops.depthwise import (
    depthwise3x3,
    depthwise3x3_backward_reference,
    depthwise3x3_reference,
)
from mmvqa_tpu_torch.ops.losses import (
    masked_mlm_nll,
    mse_distillation,
    streaming_lse,
)
from mmvqa_tpu_torch.ops.token_head import (
    fused_token_head,
    token_head_backward_reference,
    token_head_reference,
)

__all__ = [
    "serf",
    "gelu_erf",
    "vanilla_attention",
    "realformer_attention",
    "realformer_attention_backward_reference",
    "realformer_attention_packed",
    "realformer_attention_reference",
    "bn_backward_sums",
    "bn_backward_sums_reference",
    "conv1x1_stats",
    "conv1x1_stats_reference",
    "depthwise3x3",
    "depthwise3x3_backward_reference",
    "depthwise3x3_reference",
    "masked_mlm_nll",
    "mse_distillation",
    "streaming_lse",
    "fused_token_head",
    "token_head_backward_reference",
    "token_head_reference",
]
