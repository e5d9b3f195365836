"""The training step, in one process or data-parallel over a process group.

Port of ``transkun_tpu/train/step.py``: frames -> mel -> backbone -> scorer
-> semi-CRF NLL + attribute NLLs -> gradients -> quantile clip -> rectified
AdaBelief.  The loss is ``-logp.sum(-1).mean()`` over the rank's own rows
and the gradient is taken on ``loss / 50`` (ref ``train.py:134-254``).

Data parallelism (``group``): each rank's gradients and loss are
all-reduced by SUM, not averaged (the JAX package's ``psum``,
``step.py:175-177``; ref ``TrainUtil.py:48``), so with N ranks the gradient
is N times that of the concatenated batch's mean, before the clip.  No
``DistributedDataParallel``: one all-reduce of every gradient and the loss
in one flat buffer, whose gradients go on to the clip as they lie.  The
clip, the guard and AdaBelief then run on the same bits on every rank, so
the parameters stay equal bit for bit.  The metric
``loss`` is the sum over the world size (JAX ``step.py:137``).

Non-finite guard, on the device: when the loss or the global gradient norm
is NaN or Inf, the parameters, the optimizer moments and count, the clip
state and the module's saved buffers (the V1 model's BatchNorm running
statistics, which its train-mode forward updates) stay as they were; the
step counter still advances.  The metrics stay
on the device until the caller fetches them, so a step needs no host sync.

Spans (``utils.profiling``): the root ``transkun.step``, keyed by the step,
holds ``transkun.forward``, ``transkun.backward``, ``transkun.allreduce``
(with a group), ``transkun.clip`` and ``transkun.optimizer`` (the update,
the clip ring's push and the buffers' guard); a step adds one to the
``steps`` counter.  None opens inside the module, whose recompute would
replay it in the backward pass.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..parallel.dist import all_reduce_sum
from ..utils import profiling
from .optim import AdaBelief, QuantileClip, flatten


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


def dropout_seed(run_seed: int, step: int, rank: int = 0) -> int:
    """The seed of a step's dropout generator on a rank: each rank draws
    from its own stream (the JAX package folds the rank into the step's key,
    ``step.py:171``).  Rank 0's is the one-process run's, ``step * 7919 +
    run_seed``; rank r adds ``r * 0x9E3779B9``.  The seed is taken modulo
    2**32, because the CPU generator keeps only the low 32 bits of its seed
    (two seeds 2**32 apart give the same stream); an odd multiplier keeps
    the ranks of a step apart below 2**32 ranks."""
    return (step * 7919 + run_seed + rank * 0x9E3779B9) % 2**32


def make_train_step(model, clip_quantile: float = 0.8, loss_scale: float = 1.0 / 50.0, group=None):
    """step_fn(state, frames [N, C, T, W], labels, generator) -> metrics
    {"loss", "grad_norm", "clip_value", "finite"} as device tensors.  Every
    dropout mask of the step is drawn from ``generator`` (a rank's own:
    ``dropout_seed``; the V1 model's GRU seeds torch's global generator from
    it for its call, ``models.ablation.BiGRU``).  With ``group`` (a
    ``torch.distributed`` group, such as ``torch.distributed.group.WORLD``)
    the rank's gradients and loss are summed over the group's ranks, and the
    V1 model's BatchNorm sums its statistics over them."""
    loss_fn = model.make_train_loss(group=group)
    world = 1 if group is None else torch.distributed.get_world_size(group)

    def step_fn(state: TrainState, frames: torch.Tensor, labels: Tuple[torch.Tensor, ...],
                generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        with profiling.root("transkun.step", state.step):
            params = [p for _, p in state.optimizer.named]
            for p in params:
                p.grad = None
            buffers = saved_buffers(state.model.module)
            before = [b.clone() for b in buffers]
            with profiling.span("transkun.forward"):
                logp = loss_fn(frames, labels, generator)
                loss = -logp.sum(-1).mean()
            with profiling.span("transkun.backward"):
                (loss * loss_scale).backward()
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            loss = loss.detach()
            if group is not None:
                with profiling.span("transkun.allreduce"):
                    flat = all_reduce_sum(flatten(grads + [loss]), group)
                    grads, loss = flat[:-1], flat[-1] / world
            with profiling.span("transkun.clip"):
                clipped, norm, clip_value = state.clip(grads, clip_quantile)
                finite = torch.isfinite(loss) & torch.isfinite(norm)
            with profiling.span("transkun.optimizer"):
                state.optimizer.step(clipped, finite)
                state.clip.push(norm, finite)
                with torch.no_grad():
                    for b, old in zip(buffers, before):
                        b.copy_(torch.where(finite, b, old))
            for p in params:
                p.grad = None
            profiling.count("steps")
            state.step += 1
        return {"loss": loss, "grad_norm": norm, "clip_value": clip_value, "finite": finite}

    return step_fn
