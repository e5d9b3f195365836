"""Random weights from a seed, made on the device in two large draws (one
normal, one uniform) and cut into the leaves of a state_dict layout.

Each leaf takes the initializer its kind has in the published models:
LeCun normal (std 1/sqrt(fan-in)) for dense and convolution weights,
Xavier uniform for the attention projections, N(0, 1/gamma) weights and
U[0, 2 pi) phases for the random-Fourier position embeddings, ones and
zeros for normalization scales and biases, LayerScale at 1e-2, the
analysis windows at their fixed initial values.  ``overrides`` set single
entries afterwards (a config's ``assumed`` values)."""

from __future__ import annotations

import math
import re
from typing import Dict, Sequence, Tuple

import torch

from reference.frontend import gaussian_window_init

Layout = Sequence[Tuple[str, Tuple[int, ...], torch.dtype]]


def _rule(name: str, shape: Tuple[int, ...], conf: Dict):
    """-> ("normal", std) | ("uniform", lo, hi) | ("fill", value) | ("windows", which)."""
    if name.endswith("winGen.sigma"):
        return ("windows", 0)
    if name.endswith("winGen.center"):
        return ("windows", 1)
    if name.endswith(".scale"):
        return ("fill", 1e-2)
    if re.search(r"posEmbed\w*\.proj\.weight$", name):
        return ("normal", 1.0 / conf.get("posEmbedInitGamma", 1.0))
    if re.search(r"posEmbed\w*\.proj\.bias$", name):
        return ("uniform", 0.0, 2 * math.pi)
    if re.search(r"[qkv]_proj_weight$", name):
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
        return ("uniform", -bound, bound)
    if name.endswith("bias"):
        return ("fill", 0.0)
    if len(shape) == 1:
        return ("fill", 1.0)  # normalization scales
    if name.endswith("upConv1dSkip.weight"):  # [in, out, steps]: a dense map from shape[0]
        return ("normal", 1.0 / math.sqrt(shape[0]))
    fan_in = math.prod(shape) // shape[0]
    return ("normal", 1.0 / math.sqrt(fan_in))


def make(layout: Layout, conf: Dict, seed: int, device, overrides: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """A state_dict for ``layout`` (name, shape, dtype) from ``seed``."""
    rules = [(name, tuple(shape), dtype, _rule(name, tuple(shape), conf)) for name, shape, dtype in layout]
    n_normal = sum(math.prod(s) for _, s, _, r in rules if r[0] == "normal")
    n_uniform = sum(math.prod(s) for _, s, _, r in rules if r[0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    sigma, center = gaussian_window_init(conf["nExtraWins"])
    out, at_n, at_u = {}, 0, 0
    for name, shape, dtype, r in rules:
        size = math.prod(shape)
        if r[0] == "normal":
            t = normal[at_n:at_n + size].view(shape) * r[1]
            at_n += size
        elif r[0] == "uniform":
            t = uniform[at_u:at_u + size].view(shape) * (r[2] - r[1]) + r[1]
            at_u += size
        elif r[0] == "fill":
            t = torch.full(shape, r[1], device=device)
        else:
            t = torch.tensor((sigma, center)[r[1]], device=device).view(shape)
        out[name] = t.to(dtype).contiguous()
    for key, value in (overrides or {}).items():
        name, index = re.fullmatch(r"(.+)\[(-?\d+)\]", key).groups()
        out[name][int(index)] = value
    return out


def layout_of(state_dict) -> Layout:
    return [(k, tuple(v.shape), v.dtype) for k, v in state_dict.items()]
