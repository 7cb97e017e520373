from mmvqa_tpu_torch.models.effnetv2 import EffNetV2Features
from mmvqa_tpu_torch.models.embeddings import BertEmbeddings
from mmvqa_tpu_torch.models.mmbert import MMBert, mean_pooling
from mmvqa_tpu_torch.models.realformer import RealFormerEncoder
from mmvqa_tpu_torch.models.resnet import ResNetFeatures
from mmvqa_tpu_torch.models.transformer import BertEncoder
from mmvqa_tpu_torch.models.visual_tokens import VisualTokenizer

__all__ = [
    "EffNetV2Features",
    "BertEmbeddings",
    "MMBert",
    "mean_pooling",
    "RealFormerEncoder",
    "ResNetFeatures",
    "BertEncoder",
    "VisualTokenizer",
]
