from mmvqa_tpu_torch.evaluation.metrics import (
    bleu_score,
    ensemble_logits,
    per_category_accuracy,
    per_category_bleu,
    write_predictions,
    write_submission,
)

__all__ = [
    "bleu_score",
    "ensemble_logits",
    "per_category_accuracy",
    "per_category_bleu",
    "write_predictions",
    "write_submission",
]
