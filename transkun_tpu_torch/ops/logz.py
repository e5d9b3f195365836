"""The semi-CRF partition function on padded inputs: the alpha and beta
tables (CUDA kernels ``csrc/semicrf_alpha.cu`` and ``csrc/semicrf_beta.cu``
with their plain PyTorch versions) and ``log_z_padded``, whose backward is
the exact-marginal pass ``semicrf._marginals``, and ``log_z``, which takes
unpadded tensors and pads them once.

Port of ``transkun_tpu/ops/semicrf_pallas.py:219-502``, whose TPU kernels
are ``_alpha_kernel`` (``:224``) and ``_beta_kernel`` (``:321``).  Inputs:
``s_pad [Tp, Tp, NBp]`` f32 or bf16 in [end, begin, lane] (alpha) layout,
NEG-padded, upcast to f32 as it is read; ``spdiag [Tp, NBp]`` f32 = softplus
of its diagonal; the noise f32.  The alpha table takes the
shifted noise (row i = noise[i-1], row 0 and rows >= T zero), the beta table
the plain noise (row t = noise[t], rows >= T-1 zero).  Padded rows and lanes
reduce to zero-weight skip chains, so logZ = v[Tp-1] and padded lanes give
logZ 0.

On a CPU tensor each wrapper runs its plain version.  On a CUDA tensor it
launches its kernel or raises; it never falls back.  Both kernels are
bounded by their chain of Tp dependent positions (see the CUDA sources):
they take them in blocks of 8 and split each lane group's terms over a
thread-block cluster, as planned by ``launch_plan`` (beta) and
``alpha_launch_plan`` (alpha, whose far scores arrive by TMA).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Optional

import torch

from . import _build, _cluster, semicrf

# Kernel launches made by alpha_table_padded / beta_table_padded; nothing
# else changes them except a caller resetting them to 0.
alpha_launches = 0
beta_launches = 0

# suffix of the exported C function for each score dtype the kernels take
_SUFFIX_OF = {torch.float32: "", torch.bfloat16: "_bf16"}


def _lse_step(terms: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """logaddexp(skip, logsumexp over axis 0 of ``terms``) as one sum, as
    the TPU kernels take it."""
    return semicrf._logsumexp_rows(torch.cat([terms, skip[None]]))


def alpha_table_padded_plain(
    s_pad: torch.Tensor, noise_shift: torch.Tensor, spdiag: torch.Tensor
) -> torch.Tensor:
    """v[0] = spdiag[0]; v[i] = logaddexp(v[i-1] + noise_shift[i],
    logsumexp_{j<i} v[j] + s[i, j]) + spdiag[i].  Any Tp >= 1, any NBp."""
    tp, _, nb = s_pad.shape
    v = torch.empty(tp, nb, dtype=torch.float32, device=s_pad.device)
    v[0] = spdiag[0]
    for i in range(1, tp):
        v[i] = _lse_step(v[:i] + s_pad[i, :i], v[i - 1] + noise_shift[i]) + spdiag[i]
    return v


def beta_table_padded_plain(
    s_pad: torch.Tensor, noise: torch.Tensor, spdiag: torch.Tensor
) -> torch.Tensor:
    """q[Tp-1] = spdiag[Tp-1]; q[t] = logaddexp(q[t+1] + noise[t],
    logsumexp_{e>t} q[e] + s[e, t]) + spdiag[t], reading columns of the
    alpha-layout tensor."""
    tp, _, nb = s_pad.shape
    q = torch.empty(tp, nb, dtype=torch.float32, device=s_pad.device)
    q[tp - 1] = spdiag[tp - 1]
    for t in range(tp - 2, -1, -1):
        q[t] = _lse_step(q[t + 1 :] + s_pad[t + 1 :, t], q[t + 1] + noise[t]) + spdiag[t]
    return q


def launch_plan(tp: int, nbp: int, dtype: torch.dtype, n_sm: int,
                cluster: Optional[int] = None,
                max_clusters: Optional[Mapping[int, int]] = None) -> _cluster.LaunchPlan:
    """The beta kernel's grid for ``s_pad [tp, tp, nbp]`` of ``dtype`` on a
    card of ``n_sm`` SMs (``_cluster.launch_plan``): the CTAs of a lane group split
    the terms as one cluster; its partials are (max, rescaled sum) pairs."""
    return _cluster.launch_plan(tp, nbp, dtype, n_sm, cluster, max_clusters)


def alpha_launch_plan(tp: int, nbp: int, dtype: torch.dtype, n_sm: int,
                      cluster: Optional[int] = None,
                      max_clusters: Optional[Mapping[int, int]] = None) -> _cluster.LaunchPlan:
    """The alpha kernel's grid and TMA ring for ``s_pad [tp, tp, nbp]``
    (``_cluster.alpha_launch_plan``): as the beta kernel's, with a cluster of
    at most 8 CTAs."""
    return _cluster.alpha_launch_plan(tp, nbp, dtype, n_sm, cluster, max_clusters)


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for suffix in _SUFFIX_OF.values():
        fn = getattr(lib, name + suffix)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    getattr(lib, name + "_max_clusters").argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    getattr(lib, name + "_max_clusters").restype = ctypes.c_int
    getattr(lib, name + "_smem_bytes").argtypes = [ctypes.c_int] * 3
    getattr(lib, name + "_smem_bytes").restype = ctypes.c_longlong
    getattr(lib, name + "_error_string").argtypes = [ctypes.c_int]
    getattr(lib, name + "_error_string").restype = ctypes.c_char_p
    return lib


def alpha_card_plan(s_pad: torch.Tensor, cluster: Optional[int] = None) -> _cluster.LaunchPlan:
    """The plan ``alpha_table_padded_cuda`` launches ``s_pad`` with."""
    return _cluster.card_plan(s_pad, _library("semicrf_alpha").semicrf_alpha_max_clusters, cluster,
                              _cluster.alpha_launch_plan)


def beta_card_plan(s_pad: torch.Tensor, cluster: Optional[int] = None) -> _cluster.LaunchPlan:
    """The plan ``beta_table_padded_cuda`` launches ``s_pad`` with."""
    return _cluster.card_plan(s_pad, _library("semicrf_beta").semicrf_beta_max_clusters, cluster)


_CARD_PLAN_OF = {"semicrf_alpha": alpha_card_plan, "semicrf_beta": beta_card_plan}


def _launch(name: str, s_pad: torch.Tensor, noise: torch.Tensor, spdiag: torch.Tensor,
            cluster: Optional[int] = None) -> torch.Tensor:
    """Check the inputs, allocate the table and launch ``name`` on the
    current stream with its card plan's grid (``cluster`` overrides its
    cluster size)."""
    if s_pad.dtype not in _SUFFIX_OF:
        raise TypeError(f"s_pad must be float32 or bfloat16, got {s_pad.dtype}")
    tp, tp2, nbp = s_pad.shape
    for arg, a in (("s_pad", s_pad), ("noise", noise), ("spdiag", spdiag)):
        if a.device != s_pad.device or a.device.type != "cuda":
            raise ValueError(f"{arg} is on {a.device}, s_pad on {s_pad.device}")
        if a is not s_pad and a.dtype != torch.float32:
            raise TypeError(f"{arg} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError(f"{arg} must be 16-byte aligned")
    if tp2 != tp or noise.shape != (tp, nbp) or spdiag.shape != (tp, nbp):
        raise ValueError(
            f"shapes s_pad {tuple(s_pad.shape)}, noise {tuple(noise.shape)}, "
            f"spdiag {tuple(spdiag.shape)}: want [Tp,Tp,NBp], [Tp,NBp], [Tp,NBp]"
        )
    if tp == 0 or nbp == 0:
        raise ValueError(f"Tp={tp} and NBp={nbp} must be positive")
    plan = _CARD_PLAN_OF[name](s_pad, cluster)
    if nbp % plan.lanes:
        raise ValueError(f"NBp={nbp} must be a multiple of {plan.lanes}")
    if plan.smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"Tp={tp} needs {plan.smem} B of shared memory, above {_build.SMEM_LIMIT} B: "
            "chunk too long for the kernel"
        )
    lib = _library(name)
    out = torch.empty(tp, nbp, dtype=torch.float32, device=s_pad.device)
    err = getattr(lib, name + _SUFFIX_OF[s_pad.dtype])(
        s_pad.data_ptr(), noise.data_ptr(), spdiag.data_ptr(), out.data_ptr(),
        tp, nbp, plan.cluster, s_pad.device.index,
        torch.cuda.current_stream(s_pad.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {getattr(lib, name + '_error_string')(err).decode()}"
        )
    return out


def alpha_table_padded_cuda(
    s_pad: torch.Tensor, noise_shift: torch.Tensor, spdiag: torch.Tensor,
    cluster: Optional[int] = None,
) -> torch.Tensor:
    """Launch the alpha kernel with ``alpha_launch_plan``'s grid (``cluster``
    overrides its cluster size); raises on anything it does not take."""
    global alpha_launches
    v = _launch("semicrf_alpha", s_pad, noise_shift, spdiag, cluster)
    alpha_launches += 1
    return v


def beta_table_padded_cuda(
    s_pad: torch.Tensor, noise: torch.Tensor, spdiag: torch.Tensor,
    cluster: Optional[int] = None,
) -> torch.Tensor:
    """Launch the beta kernel with ``launch_plan``'s grid (``cluster``
    overrides its cluster size); raises on anything it does not take."""
    global beta_launches
    q = _launch("semicrf_beta", s_pad, noise, spdiag, cluster)
    beta_launches += 1
    return q


def alpha_table_padded(
    s_pad: torch.Tensor, noise_shift: torch.Tensor, spdiag: torch.Tensor
) -> torch.Tensor:
    """Full alpha table [Tp, NBp]: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if s_pad.device.type == "cpu":
        return alpha_table_padded_plain(s_pad, noise_shift, spdiag)
    if s_pad.device.type == "cuda":
        return alpha_table_padded_cuda(s_pad, noise_shift, spdiag)
    raise ValueError(f"no alpha kernel for device {s_pad.device}")


def beta_table_padded(
    s_pad: torch.Tensor, noise: torch.Tensor, spdiag: torch.Tensor
) -> torch.Tensor:
    """Full beta table [Tp, NBp]: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if s_pad.device.type == "cpu":
        return beta_table_padded_plain(s_pad, noise, spdiag)
    if s_pad.device.type == "cuda":
        return beta_table_padded_cuda(s_pad, noise, spdiag)
    raise ValueError(f"no beta kernel for device {s_pad.device}")


def _fb_padded(s_pad: torch.Tensor, noise_pad: torch.Tensor):
    """(logZ [NBp], v [Tp, NBp], q [Tp, NBp]): one alpha and one beta pass
    over the same score tensor."""
    spdiag = torch.nn.functional.softplus(semicrf._diag(s_pad).float()).contiguous()
    noise_pad = noise_pad.float()
    noise_shift = torch.nn.functional.pad(noise_pad[:-1], (0, 0, 1, 0)).contiguous()
    v = alpha_table_padded(s_pad, noise_shift, spdiag)
    q = beta_table_padded(s_pad, noise_pad.contiguous(), spdiag)
    return v[-1], v, q


class _LogZPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_real, s_pad, noise_pad):
        logz, v, q = _fb_padded(s_pad, noise_pad)
        ctx.t_real = t_real
        ctx.save_for_backward(s_pad, noise_pad, v, q, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        s_pad, noise_pad, v, q, logz = ctx.saved_tensors
        # _marginals takes the unpadded-convention [Tp-1, NBp] noise rows
        grad, grad_noise = semicrf._marginals(s_pad, noise_pad[:-1], v, q, logz)
        grad *= g
        row = torch.arange(grad_noise.shape[0], device=g.device)[:, None]
        grad_noise = torch.where(row < ctx.t_real - 1, grad_noise * g, 0.0)
        grad_noise = torch.nn.functional.pad(grad_noise, (0, 0, 0, 1))  # [Tp, NBp]
        return None, grad.to(s_pad.dtype), grad_noise.to(noise_pad.dtype)


class _LogZ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, score, noise):
        t, _, nb = score.shape
        tp, nbp = semicrf._pad_to(t, semicrf.PALLAS_KP), semicrf._pad_to(nb, semicrf.PALLAS_LN)
        dtype = torch.bfloat16 if score.dtype == torch.bfloat16 else torch.float32
        s_pad = torch.full((tp, tp, nbp), semicrf.NEG, dtype=dtype, device=score.device)
        s_pad[:t, :t, :nb] = score
        noise_pad = torch.zeros(tp, nbp, dtype=torch.float32, device=score.device)
        noise_pad[: t - 1, :nb] = noise
        logz, v, q = _fb_padded(s_pad, noise_pad)
        del s_pad
        v, q, logz = v[:t, :nb], q[:t, :nb], logz[:nb]
        ctx.save_for_backward(score, noise, v, q, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        score, noise, v, q, logz = ctx.saved_tensors
        grad, grad_noise = semicrf._marginals(score, noise, v, q, logz)
        grad *= g
        return grad.to(score.dtype), (grad_noise * g).to(noise.dtype)


def log_z(score: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """logZ [N] of unpadded ``score [T, T, N]`` (alpha layout: end, begin)
    and ``noise [T-1, N]``, the counterpart of the JAX package's
    ``semicrf_pallas.log_z``: padded once to the decode layout (positions to
    a multiple of ``PALLAS_KP``, lanes of ``PALLAS_LN``; NEG scores, zero
    noise), then one alpha and one beta pass (``_fb_padded``: the kernels on
    a CUDA tensor, their plain versions on a CPU tensor).  The backward is
    the exact marginals times the cotangent, for the score and for the
    noise, on the unpadded tensors; the padded copy is dropped after the
    forward."""
    return _LogZ.apply(score, noise)


def log_z_padded(t_real: int, s_pad: torch.Tensor, noise_pad: torch.Tensor) -> torch.Tensor:
    """logZ [NBp] from pre-padded, pre-masked inputs (``s_pad`` in alpha
    layout, ``noise_pad [Tp, NBp]`` with row t = noise[t]), with the
    contract of the JAX package's ``log_z_padded``: padded lanes (all-NEG
    score, zero noise) give logZ 0 and a zero score cotangent, and the noise
    cotangent is masked to the ``t_real - 1`` real rows."""
    return _LogZPadded.apply(t_real, s_pad, noise_pad)
