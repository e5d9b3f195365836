"""The port's fused attention route on the CPU against the JAX package's
``fused_attention`` run in interpret mode, as ``test_experimental_kernels.py``
runs it, at its shapes and tolerances: forward atol 2e-6, gradients atol
1e-5 (fp32, sums in another order).  Then the layers that take the route:
``BasicBlock`` and the backbone ctx with both flags set against the flax
modules with their flags set, on the same weights (atol and rtol 1e-4, as
the default route's tests), and one tiny training step of the port, fused
against default."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.backbone import Backbone as JaxBackbone
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.models.layers import BasicBlock as JaxBasicBlock
from transkun_tpu.ops import attention_pallas as ap
from transkun_tpu.ops import mlp_pallas as mp
from transkun_tpu_torch.data.note import Note
from transkun_tpu_torch.models import layers
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun, target_midi_pitches
from transkun_tpu_torch.ops import attention as ta
from transkun_tpu_torch.ops import mlp as tm
from transkun_tpu_torch.utils.convert import state_dict_from_flax

SHAPES = [(16, 13, 13, 2, 8), (4, 9, 21, 4, 8), (6, 17, 17, 8, 32), (5, 7, 7, 1, 16)]
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": 4000, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 2,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0,
    "segmentHopSizeInSecond": 1.0,
}


@pytest.fixture(autouse=True)
def interpret_mode():
    ap.INTERPRET = mp.INTERPRET = True
    yield
    ap.INTERPRET = mp.INTERPRET = False


@pytest.fixture
def fused_flags(monkeypatch):
    """Both flags set for both packages; the JAX gates also ask for a TPU
    backend, so it is told it has one and runs its kernels interpreted."""
    monkeypatch.delenv("TRANSKUN_TPU_NO_PALLAS", raising=False)
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_ATTN", "1")
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_MLP", "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _qkv(rng, b, sq, skv, d):
    return [rng.normal(size=(b, s, d)).astype(np.float32) for s in (sq, skv, skv)]


def _t(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("b,sq,skv,h,dh", SHAPES)
def test_attention_forward_matches_jax_kernel(rng, b, sq, skv, h, dh):
    q, k, v = _qkv(rng, b, sq, skv, h * dh)
    scale = 1.0 / np.sqrt(dh)
    want = np.asarray(ap.fused_attention(*map(jnp.asarray, (q, k, v)), h, scale))
    for fn in (ta.attention_plain, ta.fused_attention, layers.attention):
        got = fn(*_t((q, k, v)), h, scale)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, err_msg=fn.__name__)


@pytest.mark.parametrize("b,sq,skv,h,dh", [(4, 11, 11, 2, 8), (3, 9, 21, 4, 8)])
def test_attention_grads_match_jax_kernel(rng, b, sq, skv, h, dh):
    """``fused_attention``'s explicit backward formula against the JAX
    backward kernel."""
    q, k, v = _qkv(rng, b, sq, skv, h * dh)
    scale = 1.0 / np.sqrt(dh)
    co = rng.normal(size=(b, sq, h * dh)).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(ap.fused_attention(q, k, v, h, scale) * co), argnums=(0, 1, 2)
    )(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t((q, k, v), grad=True)
    (ta.fused_attention(tq, tk, tv, h, scale) * torch.from_numpy(co)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("b,sq,skv,h,dh", SHAPES)
def test_attention_bwd_plain_matches_autograd(rng, b, sq, skv, h, dh):
    q, k, v = _qkv(rng, b, sq, skv, h * dh)
    scale = 1.0 / np.sqrt(dh)
    do = torch.from_numpy(rng.normal(size=(b, sq, h * dh)).astype(np.float32))
    tq, tk, tv = _t((q, k, v), grad=True)
    o = ta.attention_plain(tq, tk, tv, h, scale)
    want = torch.autograd.grad(o, (tq, tk, tv), do)
    got = ta.attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), o.detach(), do, h, scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_gate_reads_the_environment_at_call_time(monkeypatch):
    for name in ("TRANSKUN_TPU_NO_PALLAS", "TRANSKUN_TPU_FUSED_ATTN", "TRANSKUN_TPU_FUSED_MLP"):
        monkeypatch.delenv(name, raising=False)
    assert not ta.use_fused_attention() and not tm.use_fused_mlp()
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_ATTN", "1")
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_MLP", "1")
    assert ta.use_fused_attention() and tm.use_fused_mlp()
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_MLP", "yes")  # the JAX gate wants "1"
    assert not tm.use_fused_mlp()
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_MLP", "1")
    monkeypatch.setenv("TRANSKUN_TPU_NO_PALLAS", "1")
    assert not ta.use_fused_attention() and not tm.use_fused_mlp()


@pytest.fixture(scope="module")
def models():
    """(flax params with every leaf moved off its init, the port's TransKun
    holding the same weights)."""
    conf = JaxModelConfig.from_dict(TINY)
    params = jax.jit(lambda k: JaxTransKun(conf).init(k, n_frames=126))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32), params
    )
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return params["params"], model


def _routes_taken(monkeypatch):
    """Count the port's calls of the two fused entry points."""
    calls = {"attention": 0, "mlp": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(ta, "fused_attention", counted("attention", ta.fused_attention))
    monkeypatch.setattr(tm, "fused_mlp", counted("mlp", tm.fused_mlp))
    return calls


def test_basic_block_fused_matches_jax_fused(models, fused_flags, monkeypatch):
    p, model = models
    calls = _routes_taken(monkeypatch)
    x = np.random.default_rng(1).normal(size=(2, 7, 11, 32)).astype(np.float32)
    want = JaxBasicBlock(size=32, num_heads=2, hidden_factor=4, hidden_factor_attn=1,
                         enabled=("F", "T")).apply(
        {"params": p["backbone"]["encoderLayers_1"]}, jnp.asarray(x), True
    )
    block = model.module.backbone.encoderLayers[1]
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert calls == {"attention": 2, "mlp": 2}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_ATTN")
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_MLP")
    with torch.no_grad():
        default = block(torch.from_numpy(x))
    assert calls == {"attention": 2, "mlp": 2}  # flags unset: the default route
    torch.testing.assert_close(got, default, atol=1e-5, rtol=0)


def test_backbone_ctx_fused_matches_jax_fused(models, fused_flags, monkeypatch):
    p, model = models
    calls = _routes_taken(monkeypatch)
    feats = np.random.default_rng(3).normal(size=(2, 126, 32, 3)).astype(np.float32)
    pitches = np.asarray(target_midi_pitches(), np.float32)
    want = JaxBackbone(
        input_size=3, base_size=8, pos_embed_init_gamma=1, n_head=2, hidden_factor=4,
        hidden_factor_attn=1, expansion_factor=2, n_layers=2, use_gradient_checkpoint=False,
    ).apply({"params": p["backbone"]}, jnp.asarray(feats), jnp.asarray(pitches), True)
    with torch.no_grad():
        got = model.module.backbone(torch.from_numpy(feats), torch.from_numpy(pitches))
    assert calls == {"attention": 4, "mlp": 4}  # 2 layers x (F, T)
    assert got.shape == (2, 90, 126, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_training_step_fused_matches_default(models, fused_flags, monkeypatch):
    """One tiny training step of the port at the flagship's
    ``contextDropoutProb`` of 0 (so the fused MLP runs in training too),
    with gradient checkpointing: the loss and every gradient of the fused route
    within 1e-4 of the default route's, relative to each tensor's largest
    entry (the explicit attention backward and the recomputed MLP against
    autograd of the written-out forms)."""
    model = TransKun(ModelConfig.from_dict({**TINY, "contextDropoutProb": 0.0}), device="cpu")
    model.load_state_dict(models[1].module.state_dict())
    calls = _routes_taken(monkeypatch)
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(2, 4000, 1)) * 0.1).astype(np.float32)
    notes = [[Note(0.1, 0.4, 60, 80), Note(0.45, 0.8, 60, 70), Note(0.2, 0.9, 64, 90),
              Note(0.0, 0.6, -64, 127, hasOnset=False)]] * 2
    loss_fn = model.make_train_loss()
    labels = model.labels(notes, 8)

    def step():
        model.module.zero_grad()
        logp = loss_fn(model.frames(audio), labels, torch.Generator().manual_seed(3))
        loss = -logp.sum(-1).mean()
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.module.named_parameters()}

    loss_f, grads_f = step()
    # 2 layers x (F, T), forward and checkpointed recompute
    assert calls == {"attention": 8, "mlp": 8}
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_ATTN")
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_MLP")
    loss_d, grads_d = step()
    assert calls == {"attention": 8, "mlp": 8}
    assert np.isfinite(loss_f) and abs(loss_f - loss_d) <= 1e-5 * abs(loss_d)
    for name, g in grads_d.items():
        bound = 1e-4 * max(float(g.abs().max()), 1e-12)
        assert float((grads_f[name] - g).abs().max()) <= bound, name


# -- bf16 inputs ---------------------------------------------------------------
#
# The JAX kernels and the port's plain versions take bf16 q, k, v (and o, do)
# to fp32, compute in fp32 and round the outputs to bf16 once.  Both sides
# start from the same bf16 bits, so they differ by fp32 summation order before
# that one rounding: an entry may land on the neighbouring bf16 value.  The
# bound is one bf16 spacing at the output's largest value.

BF = jnp.bfloat16
BF16_SHAPES = [(4, 11, 11, 2, 8), (3, 9, 21, 4, 8), (2, 17, 13, 8, 32)]


def _bf16_pair(a32):
    """The same bf16 bits as a torch tensor and a jax array."""
    t = torch.from_numpy(a32).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(BF)


def _spacing_at_max(want) -> float:
    """The bf16 spacing at the largest |value| of ``want`` (fp32 numpy)."""
    return 2.0 ** (int(np.frexp(np.abs(want).max())[1]) - 8)


def _close_bf16(got, want, spacings=1.0):
    assert got.dtype == torch.bfloat16 and want.dtype == BF
    got, want = got.detach().float().numpy(), np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= spacings * _spacing_at_max(want), (err, _spacing_at_max(want))


@pytest.mark.parametrize("b,sq,skv,h,dh", BF16_SHAPES)
def test_attention_plain_bf16_matches_jax_kernel(rng, b, sq, skv, h, dh):
    """``attention_plain`` at bf16 inputs against the JAX forward kernel
    ``_fwd`` at the same bf16 bits."""
    pairs = [_bf16_pair(a) for a in _qkv(rng, b, sq, skv, h * dh)]
    scale = 1.0 / np.sqrt(dh)
    want = ap._fwd(*[j for _, j in pairs], h, scale)
    got = ta.attention_plain(*[t for t, _ in pairs], h, scale)
    _close_bf16(got, want)


@pytest.mark.parametrize("b,sq,skv,h,dh", BF16_SHAPES)
def test_attention_bwd_plain_bf16_matches_jax_kernel(rng, b, sq, skv, h, dh):
    """``attention_bwd_plain`` at bf16 inputs against the JAX backward kernel
    ``_bwd_call``, both given the same bf16 q, k, v, o and do."""
    q, k, v = (_bf16_pair(a) for a in _qkv(rng, b, sq, skv, h * dh))
    do = _bf16_pair(rng.normal(size=(b, sq, h * dh)).astype(np.float32))
    scale = 1.0 / np.sqrt(dh)
    o_j = ap._fwd(q[1], k[1], v[1], h, scale)
    o_t = torch.from_numpy(np.array(o_j.astype(jnp.float32))).bfloat16()
    want = ap._bwd_call(q[1], k[1], v[1], o_j, do[1], h, scale)
    got = ta.attention_bwd_plain(q[0], k[0], v[0], o_t, do[0], h, scale)
    for g, w in zip(got, want):
        _close_bf16(g, w)


@pytest.mark.parametrize("b,sq,skv,h,dh", BF16_SHAPES[:2])
def test_fused_attention_bf16_autograd_matches_jax_vjp(rng, b, sq, skv, h, dh):
    """``fused_attention`` at bf16 through autograd against ``jax.vjp`` of
    the JAX ``fused_attention``: the saved o is each side's own bf16
    output, which may differ by a spacing, and delta = rowsum(do * o)
    carries that into dq and dk; two spacings."""
    q, k, v = (_bf16_pair(a) for a in _qkv(rng, b, sq, skv, h * dh))
    do = _bf16_pair(rng.normal(size=(b, sq, h * dh)).astype(np.float32))
    scale = 1.0 / np.sqrt(dh)
    o_j, vjp = jax.vjp(lambda q, k, v: ap.fused_attention(q, k, v, h, scale), q[1], k[1], v[1])
    want = vjp(do[1])
    leaves = [t.clone().requires_grad_() for t in (q[0], k[0], v[0])]
    o_t = ta.fused_attention(*leaves, h, scale)
    o_t.backward(do[0])
    _close_bf16(o_t, o_j)
    for leaf, w in zip(leaves, want):
        _close_bf16(leaf.grad, w, spacings=2.0)


def test_fused_attention_backward_casts_the_cotangent():
    """A cotangent of another type than the saved tensors goes to theirs."""
    q, k, v = (torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(i)).bfloat16()
               for i in range(3))
    do = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(3))
    o = ta.attention_plain(q, k, v, 2, 0.25)
    want = ta.attention_bwd_plain(q, k, v, o, do.bfloat16(), 2, 0.25)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.backward(ta._FusedAttention.apply(*leaves, 2, 0.25).float(), do)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, w)


@pytest.fixture(scope="module")
def bf16_model(models):
    """The port's TransKun at bf16 on the weights of ``models``."""
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu", compute_dtype=torch.bfloat16)
    model.load_state_dict(models[1].module.state_dict())
    return model


@pytest.fixture
def attn_flag(monkeypatch):
    """``TRANSKUN_TPU_FUSED_ATTN`` alone, for both packages (the JAX gate is
    told it has a TPU and runs its kernels interpreted)."""
    monkeypatch.delenv("TRANSKUN_TPU_NO_PALLAS", raising=False)
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_MLP", raising=False)
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_ATTN", "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("which", ["mhaBlockF", "mhaBlockT"])
def test_multi_head_attention_bf16_fused_matches_jax_fused(models, bf16_model, attn_flag,
                                                           monkeypatch, which):
    """``MultiHeadAttention(dtype=bfloat16)`` on the fused route: bf16
    projections, the kernel's fp32 core from bf16 q, k, v, a bf16 output,
    the bf16 out projection.  Against the flax module on its fused route
    within 2 bf16 spacings of the largest value (one for the core's output,
    one for the projection that follows it)."""
    from transkun_tpu.models.layers import MultiHeadAttention as JaxMHA

    p, _ = models
    calls = _routes_taken(monkeypatch)
    x_t, x_j = _bf16_pair(np.random.default_rng(1).normal(size=(2, 7, 11, 32)).astype(np.float32))
    want = JaxMHA(32, 2, 1.0, dtype=BF).apply(
        {"params": p["backbone"]["encoderLayers_1"][which]["mha"]}, x_j, x_j)
    with torch.no_grad():
        got = getattr(bf16_model.module.backbone.encoderLayers[1], which).module(x_t, x_t)
    assert calls == {"attention": 1, "mlp": 0}
    _close_bf16(got, want, spacings=2.0)


def test_basic_block_bf16_fused_attention_matches_jax_fused(models, bf16_model, attn_flag,
                                                            monkeypatch):
    """One ``BasicBlock`` at bf16 with ``TRANSKUN_TPU_FUSED_ATTN`` (the MLP
    on its default route, whose kernel takes fp32 only): the residual stream
    stays fp32, so the bound is 2 bf16 spacings of the largest value, as the
    default route's bf16 blocks are held to."""
    p, _ = models
    calls = _routes_taken(monkeypatch)
    x = np.random.default_rng(1).normal(size=(2, 7, 11, 32)).astype(np.float32)
    want = JaxBasicBlock(size=32, num_heads=2, hidden_factor=4, hidden_factor_attn=1,
                         enabled=("F", "T"), dtype=BF).apply(
        {"params": p["backbone"]["encoderLayers_1"]}, jnp.asarray(x), True
    )
    with torch.no_grad():
        got = bf16_model.module.backbone.encoderLayers[1](torch.from_numpy(x))
    assert calls == {"attention": 2, "mlp": 0}
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    got, want = got.numpy(), np.asarray(want)
    assert np.abs(got - want).max() <= 2.0 * 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("wrapper,n_in", [("attention_fwd_cuda", 3), ("attention_bwd_cuda", 5)])
@pytest.mark.parametrize("case", ["mixed", "fp16", "fp64"])
def test_wrapper_dtype_rules(wrapper, n_in, case, monkeypatch):
    """fp32 or bf16, all tensors of one type: anything else raises
    ``TypeError`` before the device is looked at, a library built or a
    kernel launched (so the rule can be held here, on CPU tensors)."""
    def no_library(*args):
        raise AssertionError("the dtype check comes before the library")

    monkeypatch.setattr(ta, "_library", no_library)
    inputs = [torch.zeros(2, 5, 16, dtype=torch.bfloat16) for _ in range(n_in)]
    if case == "mixed":
        inputs[1] = inputs[1].float()
    else:
        dtype = torch.float16 if case == "fp16" else torch.float64
        inputs = [a.to(dtype) for a in inputs]
    before = (ta.fwd_launches, ta.bwd_launches)
    with pytest.raises(TypeError):
        getattr(ta, wrapper)(*inputs, 2, 0.25)
    assert (ta.fwd_launches, ta.bwd_launches) == before
