"""Process groups for multi-process data parallelism (the port's
counterpart of ``transkun_tpu/parallel/mesh.py``'s ``init_distributed`` and
``process_info``, and of the reference's NCCL process group,
``train.py:29-31,400-403``).

One process a rank.  A launcher describes the group in the environment as
``torchrun`` does: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT``.  The rank's card is ``cuda:LOCAL_RANK``.  The backend
is NCCL where the rank's device is a card and gloo on the CPU; an explicit
``backend`` overrides it (two ranks that share one card need gloo: NCCL
takes one rank a card).

The collectives below act on the default group unless given another.  On a
gloo group a tensor goes through host memory; on an NCCL group it must lie
on the rank's card.  Without a group every one of them returns its input.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether a launcher described a group of more than one rank."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def free_port() -> int:
    """A free port on localhost, for a group of ranks on one node."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(argv: Callable[[int], Sequence[str]], world: int,
                 local_rank: Optional[Callable[[int], int]] = None, cwd: Optional[str] = None,
                 timeout: float = 600.0) -> None:
    """Run ``argv(rank)`` once a rank on this node, each process under the
    launcher's environment (``torchrun``'s variables, a free port on
    localhost), and wait for them all.  ``local_rank(rank)`` gives the
    rank's ``LOCAL_RANK`` (default: the rank; ranks that share card 0 give
    0).  When a rank fails or ``timeout`` seconds pass, the ranks still
    running are killed (a rank waiting in a collective would wait for the
    gone one), and the call raises with each rank's exit code and the end of
    its output."""
    port = free_port()
    procs: List[subprocess.Popen] = []
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for rank in range(world):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(rank if local_rank is None else local_rank(rank)),
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(list(argv(rank)), cwd=cwd, env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT, text=True))
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or time.monotonic() > deadline or any(codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = []
        for log in logs:
            log.seek(0)
            tails.append(log.read()[-3000:])
            log.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        late = " (timed out)" if time.monotonic() > deadline else ""
        raise RuntimeError(f"ranks exited {codes}{late}:\n" + "\n".join(
            f"-- rank {r}:\n{tail}" for r, tail in enumerate(tails)))


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a card, else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device(device_type)


def init_distributed(device_type: str = "cuda", backend: Optional[str] = None) -> bool:
    """Join the process group that the launcher's environment describes.

    Returns True when a group of more than one rank was joined (or was
    already joined in this process: a second CLI run in one process), False
    without a launcher.  A partial environment, a group of another size and
    a failed join raise: a rank never carries on alone while the others wait
    for it (the JAX package's rule, ``mesh.py:40-48``)."""
    if not launched():
        return False
    missing = [k for k in LAUNCH_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(f"a launcher set WORLD_SIZE={os.environ['WORLD_SIZE']} but not {missing}")
    world = int(os.environ["WORLD_SIZE"])
    if dist.is_initialized():  # the one benign case
        if dist.get_world_size() != world:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks is joined; the "
                               f"environment asks for {world}")
        return True
    device = rank_device(device_type)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the rank's device is a card, and CUDA is not available")
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]))
    return True


def process_info(group=None) -> Tuple[int, int]:
    """(rank, world size): the loader's sharding pair; (0, 1) without a
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _collective_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _run(x: torch.Tensor, group, fn) -> torch.Tensor:
    if not dist.is_initialized():
        return x
    t = x.to(_collective_device(group), copy=True)
    fn(t)
    return t.to(x.device)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the group's ranks, on ``x``'s device (a new tensor;
    ``x`` itself without a group).  Every rank gets the same bits."""
    return _run(x, group, lambda t: dist.all_reduce(t, dist.ReduceOp.SUM, group=group))


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward sums the cotangents over the
    group: ``psum`` and its transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def all_reduce_sum_differentiable(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce_sum`` through autograd: the backward all-reduces the
    cotangent by SUM, as the transpose of the JAX package's ``psum`` does."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``'s largest value over the group's ranks, element by element."""
    return _run(x, group, lambda t: dist.all_reduce(t, dist.ReduceOp.MAX, group=group))


def broadcast_from_0(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (rank 0 of the group)."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    return _run(x, group, lambda t: dist.broadcast(t, src, group=group))


def broadcast_module_(module: torch.nn.Module, group=None) -> None:
    """Copy rank 0's parameters and buffers into every rank's ``module``."""
    with torch.no_grad():
        for t in module.state_dict(keep_vars=True).values():
            t.copy_(broadcast_from_0(t, group))


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)
