"""The port's fused MLP route on the CPU against the JAX package's
``fused_mlp`` run in interpret mode, as ``test_experimental_kernels.py``
runs it, at its shapes and tolerances: forward atol 1e-5 (the TPU kernel's
rational erf against exact erf, 1.5e-7 an element, and sums in another
order), gradients atol 1e-4.  Then ``FFNResBlock`` under the flag against
the flax module under its flag, and the condition under which the fused
route gives way to the unfused FFN (training with dropout > 0), which is
the JAX package's ``fused_ok``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.models.layers import FFNResBlock as JaxFFNResBlock
from transkun_tpu.ops import mlp_pallas as mp
from transkun_tpu_torch.models.layers import FFNResBlock
from transkun_tpu_torch.ops import mlp as tm


@pytest.fixture(autouse=True)
def interpret_mode():
    mp.INTERPRET = True
    yield
    mp.INTERPRET = False


@pytest.fixture
def fused_flag(monkeypatch):
    monkeypatch.delenv("TRANSKUN_TPU_NO_PALLAS", raising=False)
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_MLP", "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _operands(rng, m=37, d=16, hidden=32):
    return [
        rng.normal(size=(m, d)).astype(np.float32),
        rng.normal(size=(d, hidden)).astype(np.float32) * 0.3,
        rng.normal(size=(hidden,)).astype(np.float32) * 0.1,
        rng.normal(size=(hidden, d)).astype(np.float32) * 0.3,
        rng.normal(size=(d,)).astype(np.float32) * 0.1,
    ]


@pytest.mark.parametrize("fn", [tm.mlp_plain, tm.fused_mlp, tm.mlp], ids=lambda f: f.__name__)
def test_mlp_forward_matches_jax_kernel(rng, fn, fused_flag):
    ops = _operands(rng)
    want = np.asarray(mp.fused_mlp(*map(jnp.asarray, ops)))
    got = fn(*map(torch.from_numpy, ops))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("which", ["x", "w1", "b1", "w2", "b2"])
def test_fused_mlp_grad_matches_jax(rng, which):
    """Each of the five gradients of ``fused_mlp`` (the plain version
    recomputed under autograd) against the JAX package's VJP."""
    ops = _operands(rng)
    co = rng.normal(size=ops[0].shape).astype(np.float32)
    i = ["x", "w1", "b1", "w2", "b2"].index(which)
    want = jax.grad(lambda *a: jnp.sum(mp.fused_mlp(*a) * co), argnums=i)(*map(jnp.asarray, ops))
    t = [torch.from_numpy(a).requires_grad_() for a in ops]
    (tm.fused_mlp(*t) * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(t[i].grad.numpy(), np.asarray(want), atol=1e-4)


def test_fused_mlp_grads_only_where_asked(rng):
    """Operands that need no gradient get none, and the others the same
    values as when all five are asked for."""
    ops = _operands(rng)
    full = [torch.from_numpy(a).requires_grad_() for a in ops]
    tm.fused_mlp(*full).sum().backward()
    part = [torch.from_numpy(a).requires_grad_(i in (1, 4)) for i, a in enumerate(ops)]
    tm.fused_mlp(*part).sum().backward()
    assert [a.grad is not None for a in part] == [False, True, False, False, True]
    assert torch.equal(part[1].grad, full[1].grad) and torch.equal(part[4].grad, full[4].grad)


def test_mlp_keeps_leading_dims(rng, fused_flag):
    ops = list(map(torch.from_numpy, _operands(rng, m=30)))
    flat = tm.mlp(*ops)
    nd = tm.mlp(ops[0].reshape(2, 3, 5, 16), *ops[1:])
    assert nd.shape == (2, 3, 5, 16)
    assert torch.equal(nd.reshape(30, 16), flat)


def _blocks(rng, dropout):
    """(flax params, the port's block with the same weights): nn.Linear
    holds [out, in], flax [in, out]."""
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    blk_j = JaxFFNResBlock(size=16, hidden_factor=2.0, dropout=dropout)
    params = blk_j.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1).astype(np.float32), params
    )
    blk = FFNResBlock(16, 2.0, dropout)
    p = params["params"]
    with torch.no_grad():
        blk.scale.copy_(torch.from_numpy(p["scale"]))
        blk.module[0].weight.copy_(torch.from_numpy(p["lin1"]["kernel"].T))
        blk.module[0].bias.copy_(torch.from_numpy(p["lin1"]["bias"]))
        blk.module[3].weight.copy_(torch.from_numpy(p["lin2"]["kernel"].T))
        blk.module[3].bias.copy_(torch.from_numpy(p["lin2"]["bias"]))
    return x, blk_j, params, blk


def _count_fused(monkeypatch):
    calls = []
    real = tm.fused_mlp
    monkeypatch.setattr(tm, "fused_mlp", lambda *a: calls.append(1) or real(*a))
    return calls


def test_ffn_block_fused_matches_jax_fused(rng, fused_flag, monkeypatch):
    x, blk_j, params, blk = _blocks(rng, dropout=0.0)
    calls = _count_fused(monkeypatch)
    want = np.asarray(blk_j.apply(params, jnp.asarray(x), True))
    blk.eval()
    got = blk(torch.from_numpy(x))
    assert len(calls) == 1
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    assert set(blk.state_dict()) == {"scale", "module.0.weight", "module.0.bias",
                                    "module.3.weight", "module.3.bias"}
    # dropout 0: training takes the fused route too, and gives the same values
    blk.train()
    assert torch.equal(blk(torch.from_numpy(x)), got) and len(calls) == 2
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_MLP")
    torch.testing.assert_close(blk(torch.from_numpy(x)), got, atol=1e-6, rtol=0)
    assert len(calls) == 2  # flag unset: the Sequential


@pytest.mark.parametrize("training,fused", [(False, True), (True, False)])
def test_ffn_block_dropout_gives_way_in_training(rng, fused_flag, monkeypatch, training, fused):
    """With dropout > 0 the fused route runs only when deterministic, the
    JAX package's ``fused_ok``; in training the block is the unfused FFN,
    mid-FFN dropout included."""
    x, _, _, blk = _blocks(rng, dropout=0.5)
    calls = _count_fused(monkeypatch)
    blk.train(training)
    torch.manual_seed(0)
    got = blk(torch.from_numpy(x))
    assert len(calls) == int(fused)
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_MLP")
    torch.manual_seed(0)
    unfused = blk(torch.from_numpy(x))
    if training:
        assert torch.equal(got, unfused)  # the same code and the same masks
        blk.eval()
        assert not torch.allclose(blk(torch.from_numpy(x)), got)  # dropout is on
    else:
        torch.testing.assert_close(got, unfused, atol=1e-6, rtol=0)


# -- bf16 input, the weights' two layouts, one type for all ---------------------

BF16_SPACING = 2.0 ** -7  # of a value's own magnitude


def _bf16_operands(rng, **kw):
    """The operands rounded to bf16: the same bits as torch tensors and as
    jax arrays."""
    ts = [torch.from_numpy(a).bfloat16() for a in _operands(rng, **kw)]
    return ts, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ts]


@pytest.mark.parametrize("fn", [tm.mlp_plain, tm.fused_mlp, tm.mlp], ids=lambda f: f.__name__)
def test_mlp_bf16_matches_jax_kernel(rng, fn, fused_flag):
    """bf16 operands through the JAX kernel (interpret mode) and the port.
    The kernel sums h in fp32, adds b1 in fp32 and rounds g once; the plain
    version, like the JAX package's ``mlp_reference``, rounds h and its sum
    with b1 to bf16 first: within 2 bf16 spacings of the largest output
    (measured 0.84), the result bf16."""
    ts, js = _bf16_operands(rng)
    want = np.asarray(mp.fused_mlp(*js).astype(jnp.float32))
    got = fn(*ts)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    print(f"bf16 {fn.__name__}: {err / (BF16_SPACING * np.abs(want).max()):.2f} spacings")
    assert err <= 2 * BF16_SPACING * np.abs(want).max()


def test_mlp_plain_bf16_matches_jax_reference(rng):
    """``mlp_plain`` rounds where the JAX package's ``mlp_reference`` does:
    within one bf16 spacing of the largest output (sums in another order)."""
    ts, js = _bf16_operands(rng)
    want = np.asarray(mp.mlp_reference(*js).astype(jnp.float32))
    got = tm.mlp_plain(*ts).float().numpy()
    assert np.abs(got - want).max() <= BF16_SPACING * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_transposed_view_weights_equal_row_major(rng, dtype):
    """A weight may be row-major [in, out] or the ``.t()`` view of a
    row-major [out, in] tensor, as ``nn.Linear`` holds it; the same values
    either way, no copy asked of the caller, and any other stride pattern is
    refused."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(dtype) for a in _operands(rng))
    w1t, w2t = w1.t().contiguous().t(), w2.t().contiguous().t()
    assert (tm.weight_layout("w1", w1), tm.weight_layout("w1", w1t)) == (0, 1)
    assert not w1t.is_contiguous() and torch.equal(w1t, w1)
    want = tm.mlp(x, w1, b1, w2, b2)
    for a, b in ((w1t, w2t), (w1t, w2), (w1, w2t)):
        got = tm.mlp(x, a, b1, b, b2)
        assert got.dtype == dtype
        tol = 1e-6 if dtype == torch.float32 else BF16_SPACING * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol  # sums in another order
    with pytest.raises(ValueError):
        tm.weight_layout("w1", torch.zeros(16, 64)[:, ::2])
    with pytest.raises(ValueError):
        tm.weight_layout("w1", torch.zeros(4, 16, 32)[0:1])


@pytest.mark.parametrize("which", [1, 2, 3, 4])
def test_mixed_types_raise(rng, which):
    """One type for all five tensors, checked before any device work: a
    bf16 x against an fp32 weight or bias is a ``TypeError``, and so is the
    reverse."""
    ops = [torch.from_numpy(a) for a in _operands(rng)]
    mixed = [a.bfloat16() if i == which else a for i, a in enumerate(ops)]
    with pytest.raises(TypeError):
        tm.fused_mlp(*mixed)
    mixed = [a if i == which else a.bfloat16() for i, a in enumerate(ops)]
    with pytest.raises(TypeError):
        tm.mlp(*mixed)


def test_ffn_block_hands_the_kernel_views_not_copies(rng, fused_flag, monkeypatch):
    """At fp32 ``FFNResBlock`` passes ``nn.Linear``'s own storage, transposed
    as a view; at bf16 only the casts are made, and the views of them."""
    x, _, _, blk = _blocks(rng, dropout=0.0)
    seen = []
    real = tm.fused_mlp
    monkeypatch.setattr(tm, "fused_mlp", lambda *a: seen.append(a) or real(*a))
    blk.eval()
    blk(torch.from_numpy(x))
    _, w1, _, w2, _ = seen[0]
    assert w1.data_ptr() == blk.module[0].weight.data_ptr()
    assert w2.data_ptr() == blk.module[3].weight.data_ptr()
    assert (tm.weight_layout("w1", w1), tm.weight_layout("w2", w2)) == (1, 1)
    blk.dtype = torch.bfloat16
    blk(torch.from_numpy(x).bfloat16())
    assert all(a.dtype == torch.bfloat16 for a in seen[1])
    assert (tm.weight_layout("w1", seen[1][1]), tm.weight_layout("w2", seen[1][3])) == (1, 1)


def test_ffn_block_bf16_fused_matches_jax_fused(rng, fused_flag, monkeypatch):
    """``FFNResBlock`` at bf16 under the flag against the flax block at bf16
    under its flag (the TPU kernel in interpret mode): within 2 bf16 spacings
    of the largest output (measured 0.35), the result bf16, and the fused
    route taken."""
    x, _, params, blk = _blocks(rng, dropout=0.0)
    calls = _count_fused(monkeypatch)
    x_t = torch.from_numpy(x).bfloat16()
    x_j = jnp.asarray(x_t.float().numpy()).astype(jnp.bfloat16)
    want = JaxFFNResBlock(size=16, hidden_factor=2.0, dropout=0.0, dtype=jnp.bfloat16).apply(
        params, x_j, True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    blk.dtype = torch.bfloat16
    blk.eval()
    with torch.no_grad():
        got = blk(x_t)
    assert len(calls) == 1 and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    print(f"bf16 FFNResBlock, fused: {err / (BF16_SPACING * np.abs(want).max()):.2f} spacings")
    assert err <= 2 * BF16_SPACING * np.abs(want).max()
