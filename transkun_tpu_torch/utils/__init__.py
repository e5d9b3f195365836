"""Small shared utilities."""

import torch


def compute_param_size(module: torch.nn.Module) -> float:
    """Total parameter count in millions (ref ``computeParamSize``,
    ``transkun/Util.py:8-13``)."""
    return sum(p.numel() for p in module.parameters()) / 1e6
