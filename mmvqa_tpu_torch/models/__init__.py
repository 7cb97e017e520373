from mmvqa_tpu_torch.models.effnetv2 import EffNetV2Features
from mmvqa_tpu_torch.models.embeddings import BertEmbeddings
from mmvqa_tpu_torch.models.feedback import FeedbackEncoder
from mmvqa_tpu_torch.models.img_only import ImageOnlyClassifier
from mmvqa_tpu_torch.models.mmbert import MMBert, mean_pooling
from mmvqa_tpu_torch.models.realformer import RealFormerEncoder
from mmvqa_tpu_torch.models.resnet import ResNetFeatures
from mmvqa_tpu_torch.models.supcon_encoder import SupConEncoder
from mmvqa_tpu_torch.models.transformer import BertEncoder
from mmvqa_tpu_torch.models.visual_tokens import VisualTokenizer

__all__ = [
    "EffNetV2Features",
    "BertEmbeddings",
    "FeedbackEncoder",
    "ImageOnlyClassifier",
    "MMBert",
    "mean_pooling",
    "RealFormerEncoder",
    "ResNetFeatures",
    "SupConEncoder",
    "BertEncoder",
    "VisualTokenizer",
]
