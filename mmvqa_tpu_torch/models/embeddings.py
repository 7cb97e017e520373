"""BERT-style input embeddings (counterpart of mmvqa_tpu/models/embeddings.py).

Word + position + token-type embeddings, then LayerNorm with eps 1e-12.
``MMBert`` does not pass ``max_position_embeddings`` to the JAX module, so
the position table keeps BERT's 512 rows whatever the config says. Dropout
(BERT's 0.1 unless the config overrides it) follows the LayerNorm. The sum
and the LayerNorm run in the tables' dtype; the model casts the result to
its compute dtype. Under tensor parallelism the word table's rows are split
over 'model' (``parallel.comm.vocab_parallel_embedding``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmvqa_tpu_torch.models.layers import Dropout, DropoutRng, LayerNorm
from mmvqa_tpu_torch.parallel.comm import vocab_parallel_embedding

BERT_MAX_POSITIONS = 512


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 max_position_embeddings: int = BERT_MAX_POSITIONS,
                 type_vocab_size: int = 2, dropout_rate: float = 0.1,
                 rng: Optional[DropoutRng] = None):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.word_embeddings.tp_capable = True  # rows over 'model'
        self.position_embeddings = nn.Parameter(
            torch.empty(max_position_embeddings, hidden_size))
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.layer_norm = LayerNorm(hidden_size, eps=1e-12)
        self.dropout = Dropout(dropout_rate, rng or DropoutRng(0))

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                position_offset: int = 0) -> torch.Tensor:
        """``position_offset``: the global position of the first token (a
        context rank's block of the token axis starts at c T / cp)."""
        T = input_ids.shape[-1]
        words = self.word_embeddings
        x = ((vocab_parallel_embedding(input_ids.long(), words.weight)
              if getattr(words, "tp_mode", None) == "vocab"
              else words(input_ids.long()))
             + self.position_embeddings[position_offset:position_offset + T][
                 None]
             + self.token_type_embeddings(token_type_ids.long()))
        return self.dropout(self.layer_norm(x))
