"""The run's environment: cache directories inside the checkout, the
device check, and the check that nothing of JAX or the JAX package is
loaded."""

from __future__ import annotations

import os
import sys

# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "transkun_tpu")


def prepare(root: str) -> None:
    """Fixed cache directories inside the checkout (built kernels and
    compiled code stay for the next run of the cell there); keep libraries
    from loading JAX on their own; and clear the program's opt-in flags, so
    that a cell runs the route its files name, whatever the environment.
    Call before importing torch."""
    cache = os.path.join(root, ".bench_port_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("TRANSKUN_TPU_TIMING", None)
    for flag in ("TRANSKUN_TPU_FUSED_ATTN", "TRANSKUN_TPU_FUSED_MLP", "TRANSKUN_TPU_FUSED_SOFTMAX"):
        os.environ.pop(flag, None)


def loaded_forbidden(modules=None):
    """Names in ``sys.modules`` whose top-level name (before the first dot)
    is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def require_devices(chips: int) -> str:
    """The card's name; exits without a result when CUDA is absent or
    there are fewer cards than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_port: CUDA is not available; the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        sys.exit(f"bench_port: the cell needs {chips} cards, {torch.cuda.device_count()} found")
    return torch.cuda.get_device_name(0)
