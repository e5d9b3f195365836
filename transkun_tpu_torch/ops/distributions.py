"""Distribution math of the attribute heads: continuous Bernoulli (sub-frame
onset/offset refinement) and Bernoulli (endpoint presence).

Port of ``transkun_tpu/ops/distributions.py``, in logit space: the
probs-space form of ``torch.distributions`` hits ``arctanh(+-1)`` and loses
the ``-1/l`` term once the sigmoid saturates, and gives NaN.
"""

from __future__ import annotations

import math

import torch

# |logits| below this use the Taylor branch around lambda = 1/2
_EPS_LOGIT = 8e-3


def continuous_bernoulli_log_norm(logits: torch.Tensor) -> torch.Tensor:
    """log C(lambda), lambda = sigmoid(logits):
    log|l| - [log1p(-exp(-|l|)) - log1p(exp(-|l|))], Taylor-expanded near
    0; finite and differentiable for any logit."""
    al = logits.abs()
    outside = al > _EPS_LOGIT
    safe_al = torch.where(outside, al, torch.ones_like(al))
    exact = torch.log(safe_al) - (
        torch.log1p(-torch.exp(-safe_al)) - torch.log1p(torch.exp(-safe_al))
    )
    d = torch.sigmoid(logits) - 0.5
    taylor = math.log(2.0) + 4.0 / 3.0 * d**2 + 104.0 / 45.0 * d**4
    return torch.where(outside, exact, taylor)


def continuous_bernoulli_log_prob(logits: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """log p(value) of CB(logits), value in [0, 1]."""
    return value * logits - torch.nn.functional.softplus(logits) + continuous_bernoulli_log_norm(logits)


def bernoulli_log_prob(logits: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """log p(value) of Bernoulli(logits), value in {0, 1}."""
    return value * logits - torch.nn.functional.softplus(logits)


def continuous_bernoulli_mean(logits: torch.Tensor) -> torch.Tensor:
    """E[CB(logits)] = sigmoid(l) / tanh(l/2) - 1/l, Taylor-expanded near 0."""
    outside = logits.abs() > _EPS_LOGIT
    safe_l = torch.where(outside, logits, torch.ones_like(logits))
    exact = torch.sigmoid(safe_l) / torch.tanh(safe_l / 2.0) - 1.0 / safe_l
    d = torch.sigmoid(logits) - 0.5
    taylor = 0.5 + d / 3.0 + 16.0 / 45.0 * d**3
    return torch.where(outside, exact, taylor)
