"""Optimizer stack: rectified AdaBelief + masked decoupled weight decay +
OneCycle learning rate with a warmup cutoff, and adaptive quantile gradient
clipping.

Port of ``transkun_tpu/train/optim.py``, which chains
``optax.scale_by_belief(eps_root=1e-16)``, ``optax.add_decayed_weights``
and a rectified, scheduled scale.  The arithmetic follows optax's order
step for step, in float32, and every state update takes a device-side
``finite`` flag so that a non-finite step leaves the state unchanged without
a host sync.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

# no decay: biases (the V1 GRU's ``bias_ih_l0``, ``bias_hh_l1_reverse``, ...
# too: flax names every GRU bias ``bias``), the DownConv GroupNorms (indices
# 2, 6, 10, 14) and the three position-embedding builders
_NO_DECAY = re.compile(
    r"\.bias$|\.bias_(ih|hh)_l\d+(_reverse)?$|^backbone\.downConv\.(2|6|10|14)\.|^backbone\.posEmbedBuilder")


def weight_decay_mask(named_parameters: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """name -> True where the parameter decays (ref ``TrainUtil.py:94-101``).
    LayerScale ``.scale`` and the window ``sigma``/``center`` decay."""
    return {name: _NO_DECAY.search(name) is None for name, _ in named_parameters}


def onecycle_with_cutoff(
    max_lr: float,
    n_iter: int,
    pct_start: float = 0.05,
    div_factor: float = 20.0,
    final_div_factor: float = 2.0,
    warmup_cutoff: int = 500,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """optax's ``cosine_onecycle_schedule`` whose clock starts after
    ``warmup_cutoff`` steps: step (integer tensor) -> float32 learning
    rate, on the step's device."""
    # the segment ends and half-heights in float64, rounded once to float32,
    # as optax's numpy constants are
    values = np.cumprod([max_lr / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])
    half = (values[:-1] - values[1:]) / 2.0
    bounds_l = [0, int(pct_start * n_iter), int(n_iter)]

    def schedule(step: torch.Tensor) -> torch.Tensor:
        dev = step.device
        end = torch.tensor(values[1:], dtype=torch.float32, device=dev)
        half_t = torch.tensor(half, dtype=torch.float32, device=dev)
        bounds = torch.tensor(bounds_l, device=dev)
        eff = torch.clamp(step - warmup_cutoff, 0, n_iter)
        lo, hi = bounds[:-1], bounds[1:]
        inside = (lo <= eff) & (eff < hi)
        pct = (eff - lo).float() / (hi - lo).float()
        interp = end + half_t * (torch.cos(math.pi * pct) + 1)
        lr = torch.where(inside, interp, 0.0).sum()
        return lr + (bounds[-1] <= eff).float() * end[-1]

    return schedule


def rectification_gate(count: torch.Tensor, b2: float) -> torch.Tensor:
    """RAdam rectification term, 0 while rho <= 4 (the first steps)."""
    t = count.float() + 1.0
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = torch.pow(b2, t)
    rho_t = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
    ratio = (rho_t - 4.0) * (rho_t - 2.0) * rho_inf / torch.clamp(
        (rho_inf - 4.0) * (rho_inf - 2.0) * rho_t, min=1e-8
    )
    return torch.where(rho_t > 4.0, torch.sqrt(torch.clamp(ratio, min=0.0)), 0.0)


class AdaBelief:
    """Rectified AdaBelief with masked decoupled weight decay, on a list of
    named parameters it updates in place.

    Per parameter, in optax's order: mu <- b1 mu + (1-b1) g; the prediction
    error g - mu; nu <- b2 nu + (1-b2) err^2, then + 1e-16 (kept in the
    state); bias correction; u = mu_hat / (sqrt(nu_hat) + eps); u += wd * p
    where the mask is true; p += -lr * rect * u, with lr and rect from the
    step count before its increment."""

    def __init__(
        self,
        named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
        max_lr: float = 2e-4,
        weight_decay: float = 1e-4,
        n_iter: int = 180000,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        warmup_cutoff: int = 500,
    ):
        self.named = list(named_parameters)
        self.mask = weight_decay_mask(self.named)
        self.schedule = onecycle_with_cutoff(max_lr, n_iter, warmup_cutoff=warmup_cutoff)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        dev = self.named[0][1].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = {n: torch.zeros_like(p) for n, p in self.named}
        self.nu = {n: torch.zeros_like(p) for n, p in self.named}

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], finite: torch.Tensor) -> None:
        """Apply one update from ``grads`` (aligned with the parameters);
        where ``finite`` is false, parameters, moments and count stay."""
        b1, b2 = self.b1, self.b2
        count_inc = self.count + 1
        lr = self.schedule(self.count) * rectification_gate(self.count, b2)
        bc1 = 1 - b1 ** count_inc
        bc2 = 1 - b2 ** count_inc
        for (name, p), g in zip(self.named, grads):
            mu = (1 - b1) * g + b1 * self.mu[name]
            err = g - mu
            nu = (1 - b2) * (err * err) + b2 * self.nu[name]
            nu = nu + 1e-16
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.mask[name]:
                u = u + self.weight_decay * p
            p.copy_(torch.where(finite, p + (-lr) * u, p))
            self.mu[name] = torch.where(finite, mu, self.mu[name])
            self.nu[name] = torch.where(finite, nu, self.nu[name])
        self.count = torch.where(finite, count_inc, self.count)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        dev = self.count.device
        self.count = torch.as_tensor(state["count"], dtype=torch.int32).to(dev)
        for name, _ in self.named:
            self.mu[name] = state["mu"][name].to(dev)
            self.nu[name] = state["nu"][name].to(dev)


class QuantileClip:
    """Clip gradients to the running ``quantile`` of past global gradient
    norms (ref ``train.py:239-244``): a ``maxlen`` ring buffer seeded with
    one value, ``init_value``; the quantile (linear, as ``np.quantile``) is
    over the filled slots and is taken before the current norm is pushed."""

    def __init__(self, device, init_value: float = 40.0, maxlen: int = 10000):
        self.buffer = torch.zeros(maxlen, dtype=torch.float32, device=device)
        self.buffer[0] = init_value
        self.count = torch.ones((), dtype=torch.int32, device=device)

    def quantile(self, q: float) -> torch.Tensor:
        maxlen = self.buffer.shape[0]
        n = torch.clamp(self.count, max=maxlen)
        idx = torch.arange(maxlen, device=self.buffer.device)
        s = torch.sort(torch.where(idx < n, self.buffer, math.inf)).values
        pos = q * (n.float() - 1.0)
        lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
        frac = pos - lo.float()
        return s[lo] * (1.0 - frac) + s[hi] * frac

    @torch.no_grad()
    def __call__(
        self, grads: List[torch.Tensor], q: float
    ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
        """-> (clipped grads, global norm, clip value).  ``push`` records the
        norm afterwards."""
        total = torch.zeros((), dtype=torch.float32, device=self.buffer.device)
        for g in grads:
            total = total + torch.sum(torch.square(g.float()))
        norm = torch.sqrt(total)
        clip_value = self.quantile(q)
        scale = torch.clamp(clip_value / (norm + 1e-6), max=1.0)
        return [g * scale for g in grads], norm, clip_value

    @torch.no_grad()
    def push(self, norm: torch.Tensor, finite: torch.Tensor) -> None:
        """Write ``norm`` into the next slot where ``finite``."""
        at = (self.count % self.buffer.shape[0]).long()
        self.buffer[at] = torch.where(finite, norm, self.buffer[at])
        self.count = torch.where(finite, self.count + 1, self.count)

    def load(self, buffer: torch.Tensor, count: torch.Tensor) -> None:
        dev = self.buffer.device
        self.buffer = torch.as_tensor(buffer, dtype=torch.float32).to(dev)
        self.count = torch.as_tensor(count, dtype=torch.int32).to(dev)
