"""The port's row softmax (``ops/softmax.py``) against the JAX package's
(``ops/softmax_pallas.py``) on the CPU: the port on its plain versions, the
Pallas kernels in interpret mode, the same numpy inputs through both.

Tolerances.  fp32: 1e-6 absolute on probabilities and on their cotangents
(the JAX tests' own bound; both sides compute in fp32 and differ only in
the order of the row sums).  bf16: both sides start from the same bf16 bits
and compute in fp32, so they differ only where that last bit of the fp32
result crosses a bf16 rounding boundary: one bf16 unit in the last place of
the JAX result (2**-7 relative), never more.  In the backward ``do - delta``
cancels, so the fp32 value before the rounding already differs by up to the
fp32 bound: one bf16 unit plus 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.ops import softmax_pallas as sp
from transkun_tpu_torch.ops import softmax

BF16_ULP = 2.0 ** -7  # spacing of bf16 relative to the power of two below a value


@pytest.fixture(autouse=True)
def interpret_mode():
    sp.INTERPRET = True
    yield
    sp.INTERPRET = False


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_SOFTMAX", "1")
    monkeypatch.delenv("TRANSKUN_TPU_NO_PALLAS", raising=False)


def _bf16_pair(a32: np.ndarray):
    """The same bf16 bits as a torch tensor and a jax array."""
    t = torch.from_numpy(a32).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _assert_within_one_bf16_ulp(got: torch.Tensor, want, atol: float = 0.0) -> None:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want.astype(jnp.float32)).astype(np.float64)
    # a subnormal-small want still has the spacing of the smallest normal
    ulp = BF16_ULP * 2.0 ** np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    excess = (np.abs(got - want) - atol) / ulp
    assert (excess <= 1.0).all(), float(excess.max())


@pytest.mark.parametrize("r,c", [(7, 13), (130, 149), (2049, 9), (33, 21)])
def test_forward_matches_jax_kernel(r, c):
    l = np.random.default_rng(r).normal(size=(r, c)).astype(np.float32) * 3
    want = sp._softmax_rows(jnp.asarray(l))
    got = softmax.softmax_rows(torch.from_numpy(l))
    assert got.dtype == torch.float32 and got.shape == (r, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        softmax.softmax_plain(torch.from_numpy(l)).numpy(),
        torch.softmax(torch.from_numpy(l), -1).numpy(), atol=1e-6, rtol=0)


def test_gradient_matches_jax_kernel():
    rng = np.random.default_rng(0)
    l = rng.normal(size=(33, 21)).astype(np.float32)
    co = rng.normal(size=(33, 21)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(sp._softmax_rows(x) * jnp.asarray(co)))(jnp.asarray(l))
    lt = torch.from_numpy(l).requires_grad_()
    (softmax.softmax_rows(lt) * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # the written-out backward is the cotangent autograd gives torch.softmax
    la = torch.from_numpy(l).requires_grad_()
    (torch.softmax(la, -1) * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(
        softmax.softmax_bwd_plain(torch.from_numpy(l), torch.from_numpy(co)).numpy(),
        la.grad.numpy(), atol=1e-6, rtol=0)


def test_softmax_last_nd(fused):
    l = np.random.default_rng(1).normal(size=(3, 4, 5, 11)).astype(np.float32)
    want = sp._softmax_rows(jnp.asarray(l).reshape(-1, 11)).reshape(l.shape)
    got = softmax.softmax_last(torch.from_numpy(l))
    assert got.shape == l.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # a transposed (non-contiguous) view is copied, never read wrongly
    lt = torch.from_numpy(l).transpose(1, 2)
    assert not lt.is_contiguous()
    np.testing.assert_allclose(
        softmax.softmax_last(lt).numpy(), torch.softmax(lt, -1).numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("r,c", [(16, 33), (130, 149)])
def test_bf16_input_matches_jax_kernel_on_the_same_bits(r, c):
    rng = np.random.default_rng(c)
    l_t, l_j = _bf16_pair(rng.normal(size=(r, c)).astype(np.float32) * 8)
    co_t, co_j = _bf16_pair(rng.normal(size=(r, c)).astype(np.float32))
    got = softmax.softmax_rows(l_t)
    assert got.dtype == torch.bfloat16
    _assert_within_one_bf16_ulp(got, sp._softmax_rows(l_j))
    # backward: do has the dtype of l, the result too
    want = jax.grad(lambda x: jnp.sum((sp._softmax_rows(x) * co_j).astype(jnp.float32)))(l_j)
    dl = softmax.softmax_bwd_plain(l_t, co_t)
    assert dl.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _assert_within_one_bf16_ulp(dl, want, atol=1e-6)
    lt = l_t.clone().requires_grad_()
    softmax.softmax_rows(lt).backward(co_t)
    assert torch.equal(lt.grad, dl)


def test_flag_and_no_pallas_route(monkeypatch):
    """The flag alone picks the route; NO_PALLAS overrides it; both are read
    at call time.  Unset, ``softmax_last`` is ``torch.softmax``."""
    calls = []
    monkeypatch.setattr(softmax, "softmax_rows",
                        lambda l: calls.append(tuple(l.shape)) or torch.softmax(l, -1))
    l = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 5)).astype(np.float32))
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_SOFTMAX", raising=False)
    monkeypatch.delenv("TRANSKUN_TPU_NO_PALLAS", raising=False)
    assert not softmax.use_fused_softmax()
    assert torch.equal(softmax.softmax_last(l), torch.softmax(l, -1)) and calls == []
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_SOFTMAX", "1")
    assert softmax.use_fused_softmax()
    softmax.softmax_last(l)
    assert calls == [(6, 5)]
    monkeypatch.setenv("TRANSKUN_TPU_NO_PALLAS", "1")
    assert not softmax.use_fused_softmax()
    softmax.softmax_last(l)
    assert calls == [(6, 5)]


def test_cuda_wrappers_raise_without_a_cuda_tensor():
    """A CPU tensor never reaches a kernel through the ``_cuda`` wrappers,
    and they count no launch for it."""
    l = torch.zeros(4, 5)
    before = (softmax.fwd_launches, softmax.bwd_launches)
    with pytest.raises(ValueError):
        softmax.softmax_fwd_cuda(l)
    with pytest.raises(ValueError):
        softmax.softmax_bwd_cuda(l, l)
    with pytest.raises(TypeError):
        softmax.softmax_fwd_cuda(l.double())
    with pytest.raises(ValueError):
        softmax.softmax_fwd_cuda(torch.zeros(0, 5))
    assert (softmax.fwd_launches, softmax.bwd_launches) == before


def test_explicit_softmax_attention_core_matches_jax(fused):
    """The study's explicit-softmax attention core (``q k^T * scale`` ->
    ``softmax_last`` -> ``p v``), forward and dq/dk/dv, against the same
    core on the JAX kernel.  fp32, 1e-5 absolute on unit-normal inputs
    (products summed in another order)."""
    rng = np.random.default_rng(3)
    q, k, v, co = (rng.normal(size=(3, 2, 17, 8)).astype(np.float32) for _ in range(4))
    scale = 8 ** -0.5

    def core_j(q, k, v):
        logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
        p = sp._softmax_rows(logits.reshape(-1, logits.shape[-1])).reshape(logits.shape)
        return jnp.einsum("bhqk,bhkd->bhqd", p, v)

    want = core_j(*map(jnp.asarray, (q, k, v)))
    want_g = jax.grad(lambda *a: jnp.sum(core_j(*a) * jnp.asarray(co)), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = torch.matmul(softmax.softmax_last(torch.matmul(qt, kt.transpose(-1, -2)) * scale), vt)
    (out * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for got, g in zip((qt.grad, kt.grad, vt.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=1e-5, rtol=0)
