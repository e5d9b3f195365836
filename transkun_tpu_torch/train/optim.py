"""Optimizer stack: rectified AdaBelief + masked decoupled weight decay +
OneCycle learning rate with a warmup cutoff, and adaptive quantile gradient
clipping.

Port of ``transkun_tpu/train/optim.py``, which chains
``optax.scale_by_belief(eps_root=1e-16)``, ``optax.add_decayed_weights``
and a rectified, scheduled scale.  The arithmetic follows optax's order
step for step, in float32, and every state update takes a device-side
``finite`` flag so that a non-finite step leaves the state unchanged without
a host sync.

Both run on one flat float32 buffer of every leaf (the gradients gathered
by one ``torch.cat``, or the data-parallel all-reduce's buffer as it
stands), as a fixed handful of whole-buffer operations: the number of
launches a step does not grow with the number of leaves, and a step moves
no value between the host and the device.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Sequence, Tuple, Union

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


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' entries in one flat buffer, in order (one ``torch.cat``)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _flat_float32(grads: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
    """``grads`` as one flat float32 buffer: a flat buffer as it is, a list
    of leaves gathered by ``flatten``."""
    g = grads if isinstance(grads, torch.Tensor) else flatten(grads)
    if g.dtype != torch.float32 or g.dim() != 1:
        raise TypeError(f"gradients must be float32 leaves or one flat float32 buffer, got {g.dtype} "
                        f"of shape {tuple(g.shape)}")
    return g


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
    rate, on the step's device.

    The step's segment is looked up on the device, and only its cosine is
    taken: the same float32 operations, in the same order, as optax's sum
    over the segments gives for it.  Past ``n_iter`` the rate stays at the
    last segment's end, a segment of half-height 0.  The tables go to a
    device once, at the first call there: a copy from the host on every
    call would wait for the device's queue."""
    # the segment ends and half-heights in float64, rounded once to float32,
    # as optax's numpy constants are
    values = np.cumprod([max_lr / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])
    half = (values[:-1] - values[1:]) / 2.0
    bounds = [0, int(pct_start * n_iter), int(n_iter)]
    # a segment a row: length, end value, half-height
    rows = [[bounds[i + 1] - bounds[i], values[i + 1], half[i]] for i in range(2)] + [[1, values[-1], 0.0]]
    tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def schedule(step: torch.Tensor) -> torch.Tensor:
        dev = step.device
        if dev not in tables:
            tables[dev] = (torch.tensor(bounds[1:], device=dev), torch.tensor(bounds, device=dev),
                           torch.tensor(rows, dtype=torch.float32, device=dev))
        inner, starts, segments = tables[dev]
        eff = torch.clamp(step - warmup_cutoff, 0, n_iter)
        seg = torch.bucketize(eff, inner, right=True).reshape(1)
        length, end, half_height = torch.index_select(segments, 0, seg)[0]
        pct = (eff - torch.index_select(starts, 0, seg)[0]).float() / length
        return end + half_height * (torch.cos(math.pi * pct) + 1)

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
    named float32 parameters it updates in place.

    Per entry, in optax's order: mu <- b1 mu + (1-b1) g; the prediction
    error g - mu; nu <- b2 nu + (1-b2) err^2, then + 1e-16 (kept in the
    state); bias correction; u = mu_hat / (sqrt(nu_hat) + eps); u += wd * p
    where the mask is true; p += -lr * rect * u, with lr and rect from the
    step count before its increment.

    The moments live in two flat buffers in the parameters' order; ``mu``
    and ``nu`` map each name to its view of them.  A step reads the
    parameters into one flat buffer, updates it and the moments as whole
    buffers, and writes the parameters back with one ``_foreach_copy_``: the
    parameters stay the module's own tensors (the V1 GRU's weights keep
    cuDNN's single chunk)."""

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
        wrong = [name for name, p in self.named if p.dtype != torch.float32]
        if wrong:
            raise TypeError(f"AdaBelief updates float32 parameters only: {wrong[:3]}")
        self.mask = weight_decay_mask(self.named)
        self.schedule = onecycle_with_cutoff(max_lr, n_iter, warmup_cutoff=warmup_cutoff)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        dev = self.named[0][1].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self._numels = [p.numel() for _, p in self.named]
        self._decays = torch.cat([torch.full((p.numel(),), self.mask[n], device=dev) for n, p in self.named])
        self._mu = torch.zeros(sum(self._numels), dtype=torch.float32, device=dev)
        self._nu = torch.zeros_like(self._mu)
        names = [n for n, _ in self.named]
        self.mu = dict(zip(names, self.views(self._mu)))
        self.nu = dict(zip(names, self.views(self._nu)))

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each parameter's view of a flat buffer in the parameters' order."""
        return [t.view_as(p) for t, (_, p) in zip(flat.split(self._numels), self.named)]

    @torch.no_grad()
    def step(self, grads: Union[torch.Tensor, Sequence[torch.Tensor]], finite: torch.Tensor) -> None:
        """Apply one update from ``grads`` (a flat buffer in the parameters'
        order, or a list aligned with them); where ``finite`` is false,
        parameters, moments and count stay."""
        g = _flat_float32(grads)
        b1, b2 = self.b1, self.b2
        count_inc = self.count + 1
        lr = self.schedule(self.count) * rectification_gate(self.count, b2)
        bc1 = 1 - b1 ** count_inc
        bc2 = 1 - b2 ** count_inc
        params = [p for _, p in self.named]
        p = flatten(params)
        mu = (1 - b1) * g + b1 * self._mu
        err = g - mu
        nu = (1 - b2) * (err * err) + b2 * self._nu
        nu = nu + 1e-16
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        u = torch.where(self._decays, u + self.weight_decay * p, u)
        torch._foreach_copy_(params, self.views(torch.where(finite, p + (-lr) * u, p)))
        torch.where(finite, mu, self._mu, out=self._mu)
        torch.where(finite, nu, self._nu, out=self._nu)
        self.count = torch.where(finite, count_inc, self.count)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        dev = self.count.device
        self.count = torch.as_tensor(state["count"], dtype=torch.int32).to(dev)
        for name, _ in self.named:
            self.mu[name].copy_(state["mu"][name])
            self.nu[name].copy_(state["nu"][name])


class QuantileClip:
    """Clip gradients to the running ``quantile`` of past global gradient
    norms (ref ``train.py:239-244``): a ``maxlen`` ring buffer seeded with
    one value, ``init_value``; the quantile (linear, as ``np.quantile``) is
    over the filled slots and is taken before the current norm is pushed.
    Every index into the ring is a device tensor read by a gather or a
    scatter, never by the host."""

    def __init__(self, device, init_value: float = 40.0, maxlen: int = 10000):
        self.buffer = torch.zeros(maxlen, dtype=torch.float32, device=device)
        self.buffer[0] = init_value
        self.count = torch.ones((), dtype=torch.int32, device=device)
        self._slots = torch.arange(maxlen, device=device)

    def quantile(self, q: float) -> torch.Tensor:
        n = torch.clamp(self.count, max=self.buffer.shape[0])
        s = torch.sort(torch.where(self._slots < n, self.buffer, math.inf)).values
        pos = q * (n.float() - 1.0)
        lo = torch.floor(pos)
        frac = pos - lo
        below, above = torch.index_select(s, 0, torch.stack([lo, torch.ceil(pos)]).long())
        return below * (1.0 - frac) + above * frac

    @torch.no_grad()
    def __call__(
        self, grads: Union[torch.Tensor, Sequence[torch.Tensor]], q: float
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (the clipped gradients as one flat buffer, global norm, clip
        value).  ``grads``: a flat float32 buffer, or a list of float32
        leaves, which are gathered into one.  ``push`` records the norm
        afterwards."""
        g = _flat_float32(grads)
        norm = torch.sqrt(torch.sum(torch.square(g)))
        clip_value = self.quantile(q)
        scale = torch.clamp(clip_value / (norm + 1e-6), max=1.0)
        return g * scale, norm, clip_value

    @torch.no_grad()
    def push(self, norm: torch.Tensor, finite: torch.Tensor) -> None:
        """Write ``norm`` into the next slot where ``finite``."""
        at = (self.count % self.buffer.shape[0]).long().reshape(1)
        kept = torch.index_select(self.buffer, 0, at)
        self.buffer.index_copy_(0, at, torch.where(finite, norm, kept))
        self.count = torch.where(finite, self.count + 1, self.count)

    def load(self, buffer: torch.Tensor, count: torch.Tensor) -> None:
        dev = self.buffer.device
        self.buffer = torch.as_tensor(buffer, dtype=torch.float32).to(dev)
        self.count = torch.as_tensor(count, dtype=torch.int32).to(dev)
        self._slots = torch.arange(self.buffer.shape[0], device=dev)
