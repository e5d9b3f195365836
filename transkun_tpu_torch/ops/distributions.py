"""Continuous-Bernoulli mean for the onset/offset refinement head.

Port of ``continuous_bernoulli_mean`` in ``transkun_tpu/ops/distributions.py``,
in logit space: the probs-space form of ``torch.distributions`` loses the
``-1/l`` term once the sigmoid saturates and gives NaN.
"""

from __future__ import annotations

import torch

# |logits| below this use the Taylor branch around lambda = 1/2
_EPS_LOGIT = 8e-3


def continuous_bernoulli_mean(logits: torch.Tensor) -> torch.Tensor:
    """E[CB(logits)] = sigmoid(l) / tanh(l/2) - 1/l, Taylor-expanded near 0."""
    outside = logits.abs() > _EPS_LOGIT
    safe_l = torch.where(outside, logits, torch.ones_like(logits))
    exact = torch.sigmoid(safe_l) / torch.tanh(safe_l / 2.0) - 1.0 / safe_l
    d = torch.sigmoid(logits) - 0.5
    taylor = 0.5 + d / 3.0 + 16.0 / 45.0 * d**3
    return torch.where(outside, exact, taylor)
