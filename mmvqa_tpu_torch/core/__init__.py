from mmvqa_tpu_torch.core.config import (
    Config,
    pretrain_config,
    supcon_config,
    vqa_config,
)

__all__ = ["Config", "pretrain_config", "supcon_config", "vqa_config"]
