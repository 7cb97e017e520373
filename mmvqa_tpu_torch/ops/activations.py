"""Activation functions (counterpart of mmvqa_tpu/ops/activations.py).

SERF, ``x * erf(log1p(exp(x)))`` with an overflow clamp at +50, is the
activation of the whole model. bf16 inputs take the sigmoid-gate polynomial
``x * sigmoid(p5(x))``, whose error (1.1e-3 over all reals) is below bf16's
resolution at unit scale; fp32 inputs always get the exact form.
"""

from __future__ import annotations

import torch

SERF_CLAMP = 50.0
# degree-5 polynomial of the gate's logit, highest power first
SERF_P5 = (
    4.743144768698157e-04,
    9.427917061937980e-03,
    7.255023041520858e-02,
    2.832661920672991e-01,
    1.605305418315285e+00,
    7.293287033146151e-01,
)


def serf_exact(x: torch.Tensor) -> torch.Tensor:
    return x * torch.erf(torch.log1p(torch.exp(torch.clamp(x, max=SERF_CLAMP))))


def serf_fast(x: torch.Tensor) -> torch.Tensor:
    """``z * sigmoid(p5(z))`` computed in fp32, returned in x's dtype."""
    z = x.float()
    q = torch.full_like(z, SERF_P5[0])
    for c in SERF_P5[1:]:
        q = q * z + c
    return (z * torch.sigmoid(q)).to(x.dtype)


def serf(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return serf_fast(x)
    return serf_exact(x)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU of the BERT encoder's feed-forward, in the JAX
    package's op order: ``x * 0.5 * (1 + erf(x / sqrt(2)))``, each step in
    x's dtype, sqrt(2) rounded to that dtype first."""
    root2 = float(torch.tensor(2.0, dtype=x.dtype).sqrt())
    return x * 0.5 * (1.0 + torch.erf(x / root2))
