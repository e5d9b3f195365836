"""The single-process training step.

Port of ``transkun_tpu/train/step.py`` without the mesh: frames -> mel ->
backbone -> scorer -> semi-CRF NLL + attribute NLLs -> gradients -> quantile
clip -> rectified AdaBelief.  The loss is ``-logp.sum(-1).mean()`` and the
gradient is taken on ``loss / 50`` (ref ``train.py:134-254``).

Non-finite guard, on the device: when the loss or the global gradient norm
is NaN or Inf, the parameters, the optimizer moments and count, the clip
state and the module's saved buffers (the V1 model's BatchNorm running
statistics, which its train-mode forward updates) stay as they were; the
step counter still advances.  The metrics stay
on the device until the caller fetches them, so a step needs no host sync.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .optim import AdaBelief, QuantileClip


class TrainState:
    """The model's parameters (updated in place), the optimizer, the clip
    state and the host step counter."""

    def __init__(self, model, optimizer: AdaBelief, clip: Optional[QuantileClip] = None, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.clip = clip if clip is not None else QuantileClip(model.device)
        self.step = step


def saved_buffers(module: torch.nn.Module) -> List[torch.Tensor]:
    """The buffers of ``module`` that its state_dict saves (BatchNorm
    running statistics; the V2 model has none), as the live tensors."""
    params = {name for name, _ in module.named_parameters()}
    return [t for name, t in module.state_dict(keep_vars=True).items() if name not in params]


def make_train_step(model, clip_quantile: float = 0.8, loss_scale: float = 1.0 / 50.0):
    """step_fn(state, frames [N, C, T, W], labels, generator) -> metrics
    {"loss", "grad_norm", "clip_value", "finite"} as device tensors.  Every
    dropout mask of the step is drawn from ``generator``, except the V1
    model's GRU's between its layers (``nn.GRU``'s own, from torch's global
    generator)."""
    loss_fn = model.make_train_loss()

    def step_fn(state: TrainState, frames: torch.Tensor, labels: Tuple[torch.Tensor, ...],
                generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        params = [p for _, p in state.optimizer.named]
        for p in params:
            p.grad = None
        buffers = saved_buffers(state.model.module)
        before = [b.clone() for b in buffers]
        logp = loss_fn(frames, labels, generator)
        loss = -logp.sum(-1).mean()
        (loss * loss_scale).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        clipped, norm, clip_value = state.clip(grads, clip_quantile)
        loss = loss.detach()
        finite = torch.isfinite(loss) & torch.isfinite(norm)
        state.optimizer.step(clipped, finite)
        state.clip.push(norm, finite)
        with torch.no_grad():
            for b, old in zip(buffers, before):
                b.copy_(torch.where(finite, b, old))
        for p in params:
            p.grad = None
        state.step += 1
        return {"loss": loss, "grad_norm": norm, "clip_value": clip_value, "finite": finite}

    return step_fn
