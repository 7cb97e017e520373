from mmvqa_tpu_torch.similarity.calculators import SimilarityCalculator, build_mask

__all__ = ["SimilarityCalculator", "build_mask"]
