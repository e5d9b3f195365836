"""The port's bf16 configuration (``compute_dtype=torch.bfloat16``, the CLIs'
``--bf16``) against the JAX package's (``compute_dtype=jnp.bfloat16``) on the
CPU, the same fp32 parameters driving both (``state_dict_from_flax``), the
same numpy inputs through both; the Pallas kernels in interpret mode, the
port on its plain versions.

Tolerances, each stated where it is used:

* Exact where both sides start from the same bf16 bits and compute in fp32
  with order-independent steps: the Viterbi pointer tables.
* The fp32 bounds of ``test_torch_logz.py`` (2e-4 on the tables, 1e-3 on
  logZ) where both sides upcast the same bf16 bits and sum in fp32 in
  another order; a bf16 cotangent besides may land on the neighbouring bf16
  value.
* ``SPACINGS`` bf16 spacings (2**-7) of the tensor's largest magnitude where
  two bf16 products differ only by summation order or by where an
  elementwise chain is rounded (XLA on the CPU may keep an fp32 intermediate
  that PyTorch rounds): one rounding flips an entry by one spacing of its own
  magnitude, and a few layers add up.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.data.labels import encode_batch
from transkun_tpu.data.note import Note
from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.backbone import Backbone as JaxBackbone
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.models.layers import FFNResBlock as JaxFFN
from transkun_tpu.models.layers import MultiHeadAttention as JaxMHA
from transkun_tpu.models.layers import ScaledInnerProductIntervalScorer as JaxScorer
from transkun_tpu.models.transkun import TransKunModule as JaxModule
from transkun_tpu.models.transkun import log_prob_padded as jax_log_prob_padded
from transkun_tpu.ops import frontend as jfrontend
from transkun_tpu.ops import semicrf_pallas as sp
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun, log_prob_padded, target_midi_pitches
from transkun_tpu_torch.ops import frontend, logz, semicrf, viterbi
from transkun_tpu_torch.utils.convert import state_dict_from_flax

from test_torch_train import _synth_piece  # a sine-note wav with its MIDI
from test_torch_transcribe import _piece  # a dense int16-exact sine-note piece
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


FS = 4000
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 2,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0,
    "segmentHopSizeInSecond": 1.0,
}
TINY1 = {**TINY, "nLayers": 1}
PITCHES = target_midi_pitches()
NEG = -1e30
BF = jnp.bfloat16
BF16_SPACING = 2.0 ** -7
SPACINGS = 2.0  # measured: 0.5-0.85 on the FFN, the backbone's ctx and the whole module's

@pytest.fixture(autouse=True)
def interpret_mode():
    sp.INTERPRET = True
    yield
    sp.INTERPRET = False


def _jittered_params(conf_dict, n_frames, seed):
    """flax params (fp32) with every leaf moved off its init."""
    model = JaxTransKun(JaxModelConfig.from_dict(conf_dict))
    params = jax.jit(lambda k: model.init(k, n_frames=n_frames))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32), params
    )


def _port(conf_dict, params, compute_dtype=torch.bfloat16):
    model = TransKun(ModelConfig.from_dict(conf_dict), device="cpu", compute_dtype=compute_dtype)
    model.load_state_dict(state_dict_from_flax(params))
    return model


@pytest.fixture(scope="module")
def models():
    """(fp32 flax params of the two-layer tiny model, the port's bf16
    TransKun holding them)."""
    params = _jittered_params(TINY, 126, 5)
    return params["params"], _port(TINY, params)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _close(got, want, spacings=SPACINGS, dtype=None):
    """|got - want| <= ``spacings`` bf16 spacings of max |want|; the dtypes
    of the two sides must be the same (``dtype``, a torch dtype)."""
    if dtype is not None:
        assert got.dtype == dtype, got.dtype
        assert want.dtype == {torch.bfloat16: BF, torch.float32: jnp.float32}[dtype], want.dtype
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    bound = spacings * BF16_SPACING * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (float(np.abs(got - want).max()), float(bound))


def _bf16_pair(a32: np.ndarray):
    """The same bf16 bits as a torch tensor and a jax array."""
    t = torch.from_numpy(a32).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(BF)


# -- the modules that hold a kernel, from a bf16 score ----------------------------


def _decode_inputs(rng, t, nb, ties):
    tp, nbp = -(-t // 8) * 8, -(-nb // 128) * 128
    if ties:  # small integers: exact in bf16, equal candidates abound
        s = rng.integers(-3, 3, size=(t, t, nb)).astype(np.float32)
        noise = rng.integers(-1, 2, size=(t - 1, nb)).astype(np.float32)
    else:
        s = rng.normal(size=(t, t, nb)).astype(np.float32)
        noise = rng.normal(size=(t - 1, nb)).astype(np.float32) * 0.1
    s_t = np.full((tp, tp, nbp), NEG, np.float32)
    s_t[:t, :t, :nb] = s
    noise_p = np.zeros((tp, nbp), np.float32)
    noise_p[: t - 1, :nb] = noise
    return s_t, noise_p


@pytest.mark.parametrize("t,nb,ties", [(13, 3, False), (37, 130, False), (24, 90, True)])
def test_viterbi_tables_from_bf16_scores_equal_pallas_kernel(t, nb, ties):
    """Exact: the same bf16 bits, upcast on both sides, and fp32 adds,
    compares and maxima."""
    s_np, noise = _decode_inputs(np.random.default_rng(t), t, nb, ties)
    s_t, s_j = _bf16_pair(s_np)
    diag = torch.diagonal(s_t.float()).t().contiguous()  # the rounded diagonal, fp32
    gate = (diag * (diag > 0)).numpy()
    want = sp.viterbi_backward_tables_padded(s_j, jnp.asarray(noise), jnp.asarray(gate))
    before = viterbi.launches
    got = viterbi.viterbi_backward_tables_padded(
        s_t, torch.from_numpy(noise), torch.from_numpy(gate))
    assert viterbi.launches == before and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # rounding the scores to bf16 is what changes a table, not the kernel
    same_as_fp32 = viterbi.viterbi_backward_tables_padded(
        s_t.float(), torch.from_numpy(noise), torch.from_numpy(gate))
    assert torch.equal(got, same_as_fp32)


def test_viterbi_route_1b_from_bf16_scores_equals_pallas(monkeypatch):
    """Unpadded alpha-layout bf16 scores through the pad-and-transpose
    wrapper: the pointer tables of the JAX Pallas wrapper, exactly, and the
    padded tensor handed to the kernel wrapper stays bf16."""
    t, nb = 40, 7
    rng = np.random.default_rng(140)
    s_t, s_j = _bf16_pair(rng.normal(size=(t, t, nb)).astype(np.float32))
    n_t, n_j = _bf16_pair((rng.normal(size=(t - 1, nb)) * 0.5).astype(np.float32))
    seen = []
    inner = semicrf.viterbi_backward_tables_padded

    def record(s_pad, noise, gate):
        seen.append((s_pad.dtype, noise.dtype, gate.dtype, tuple(s_pad.shape)))
        return inner(s_pad, noise, gate)

    monkeypatch.setattr(semicrf, "viterbi_backward_tables_padded", record)
    ptr, diag = semicrf.viterbi_backward_tables(s_t, n_t)
    assert seen == [(torch.bfloat16, torch.float32, torch.float32, (40, 40, 128))]
    ptr_j, diag_j = sp.viterbi_backward_tables(s_j, n_j)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(ptr_j))
    np.testing.assert_array_equal(diag.numpy(), np.asarray(diag_j))


def _padded_bf16_scores(rng, t, nb, tp, nbp):
    s = rng.normal(size=(t, t, nb)).astype(np.float32)
    n = (rng.normal(size=(t - 1, nb)) * 0.5).astype(np.float32)
    s_pad = np.full((tp, tp, nbp), NEG, np.float32)
    s_pad[:t, :t, :nb] = s
    noise_pad = np.zeros((tp, nbp), np.float32)
    noise_pad[: t - 1, :nb] = n
    return _bf16_pair(s_pad), noise_pad


@pytest.mark.parametrize("t,nb", [(13, 3), (37, 5)])
def test_alpha_beta_tables_from_bf16_scores_match_pallas(t, nb):
    """2e-4 absolute, the fp32 test's bound: both sides upcast the same bf16
    bits and sum in fp32, in another order."""
    tp, nbp = -(-t // 8) * 8, 128
    (s_t, s_j), noise_pad = _padded_bf16_scores(np.random.default_rng(t), t, nb, tp, nbp)
    spdiag = torch.nn.functional.softplus(torch.diagonal(s_t).t().float()).contiguous()
    shift = np.concatenate([np.zeros_like(noise_pad[:1]), noise_pad[:-1]])
    v = logz.alpha_table_padded(s_t, torch.from_numpy(shift), spdiag)
    q = logz.beta_table_padded(s_t, torch.from_numpy(noise_pad), spdiag)
    v_p = sp.alpha_table_padded(s_j, jnp.asarray(shift), jnp.asarray(spdiag.numpy()))
    q_p = sp.beta_table_padded(s_j, jnp.asarray(noise_pad), jnp.asarray(spdiag.numpy()))
    assert v.dtype == q.dtype == torch.float32
    np.testing.assert_allclose(v.numpy(), np.asarray(v_p), atol=2e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_p), atol=2e-4)
    np.testing.assert_array_equal(v.numpy()[:, nb:], 0.0)


def test_log_z_padded_from_bf16_scores_matches_pallas():
    """logZ within 1e-3 (the fp32 test's bound).  The score cotangent comes
    back in bf16 on both sides: the fp32 marginals agree within 1e-3, so a
    rounded entry may land on the neighbouring bf16 value: 1e-3 plus one
    bf16 spacing of the entry.  A diagonal entry besides carries
    exp(-2 softplus(s)) with the softplus taken in bf16, which the two
    libraries round at different steps (one rounding in PyTorch, one per
    operation of ``logaddexp`` in XLA): 3 spacings there (measured 1.5).
    Padded lanes: logZ 0, cotangent 0."""
    t, nb, tp, nbp = 21, 5, 24, 128
    rng = np.random.default_rng(2)
    (s_t, s_j), noise_pad = _padded_bf16_scores(rng, t, nb, tp, nbp)
    w = rng.normal(size=nbp).astype(np.float32)
    s_t = s_t.requires_grad_()
    n_t = torch.from_numpy(noise_pad).requires_grad_()
    lz = logz.log_z_padded(t, s_t, n_t)
    (lz * torch.from_numpy(w)).sum().backward()
    lz_j, (gs_j, gn_j) = jax.value_and_grad(
        lambda a, b: (sp.log_z_padded(t, a, b) * w).sum(), argnums=(0, 1)
    )(s_j, jnp.asarray(noise_pad))
    want_lz = sp.log_z_padded(t, s_j, jnp.asarray(noise_pad))
    assert lz.dtype == torch.float32 and s_t.grad.dtype == torch.bfloat16 and gs_j.dtype == BF
    np.testing.assert_allclose(lz.detach().numpy(), np.asarray(want_lz), atol=1e-3)
    np.testing.assert_allclose(lz.detach().numpy()[nb:], 0.0, atol=1e-6)
    got, want = _f32(s_t.grad), _f32(gs_j)
    spacings = np.where(np.eye(tp, dtype=bool)[:, :, None], 3.0, 1.0)
    assert (np.abs(got - want) <= 1e-3 + spacings * BF16_SPACING * np.abs(want)).all()
    np.testing.assert_allclose(n_t.grad.numpy(), np.asarray(gn_j), atol=1e-3)
    np.testing.assert_array_equal(got[:, :, nb:], 0.0)
    np.testing.assert_array_equal(n_t.grad.numpy()[t - 1:], 0.0)


def test_eval_path_gathers_bf16_and_sums_fp32():
    """Path scores from a bf16 score tensor: gathered as bf16, summed in
    fp32 on both sides; 1e-5 relative (the fp32 test's bound)."""
    t, nb = 30, 6
    rng = np.random.default_rng(3)
    s_t, s_j = _bf16_pair(rng.normal(size=(t, t, nb)).astype(np.float32))
    n = (rng.normal(size=(t - 1, nb)) * 0.5).astype(np.float32)
    intervals = []
    for _ in range(nb):
        cuts = np.sort(rng.choice(t, size=8, replace=False))
        intervals.append([(int(a), int(b)) for a, b in zip(cuts[::2], cuts[1::2])])
    begins, ends, mask = semicrf.pad_intervals(intervals, k=8)
    from transkun_tpu.ops import semicrf as jsemicrf

    want = jsemicrf.eval_path_padded(
        s_j, jnp.asarray(n), jnp.asarray(begins), jnp.asarray(ends), jnp.asarray(mask))
    got = semicrf.eval_path_padded(
        s_t, torch.from_numpy(n), *(torch.from_numpy(a) for a in (begins, ends, mask)))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the model's modules at bf16 ----------------------------------------------------


def test_mel_spectrum_gemm_bf16_products_give_fp32():
    """The DFT operands are rounded to bf16 on both sides and multiplied
    with an fp32 result, so only the order of the fp32 sums differs: 1e-5
    absolute on a log-mel in [0, 1].  The rounding is in force: the result
    moves away from the fp32 mel by more than that."""
    frames = (np.random.default_rng(4).normal(size=(1, 1, 126, 256)) * 0.1).astype(np.float32)
    wins = np.random.default_rng(1).uniform(0.1, 1, size=(3, 256)).astype(np.float32)
    fbank = jfrontend.melscale_fbanks(129, 30, 1900, 32, FS)
    consts = jfrontend.dft_mel_matrices(256, fbank)
    want = jfrontend.mel_spectrum_gemm(
        jnp.asarray(frames), jnp.asarray(wins), *map(jnp.asarray, consts),
        to_mono=True, compute_dtype=BF)
    args = [torch.from_numpy(a) for a in (frames, wins, *consts)]
    got = frontend.mel_spectrum_gemm(*args, to_mono=True, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    fp32 = frontend.mel_spectrum_gemm(*args, to_mono=True)
    assert float((got - fp32).abs().max()) > 1e-4


def test_multi_head_attention_bf16(models):
    """bf16 projections, fp32 logits from the bf16 q and k, p rounded to
    bf16, the row sum of the rounded p, the division in bf16."""
    p, model = models
    x = np.random.default_rng(1).normal(size=(2, 7, 11, 32)).astype(np.float32)
    x_t, x_j = _bf16_pair(x)
    want = JaxMHA(32, 2, 1.0, dtype=BF).apply(
        {"params": p["backbone"]["encoderLayers_1"]["mhaBlockF"]["mha"]}, x_j, x_j)
    with torch.no_grad():
        got = model.module.backbone.encoderLayers[1].mhaBlockF.module(x_t, x_t)
    _close(got, want, dtype=torch.bfloat16)


def test_ffn_res_block_bf16(models):
    """Weights and biases cast to bf16, the bias added after the rounded
    product, GELU on a bf16 tensor, the residual in the input's dtype."""
    p, model = models
    x_t, x_j = _bf16_pair(np.random.default_rng(1).normal(size=(2, 7, 11, 32)).astype(np.float32))
    want = JaxFFN(32, 4, 0.0, dtype=BF).apply(
        {"params": p["backbone"]["encoderLayers_1"]["fnnBlockF"]}, x_j, True)
    with torch.no_grad():
        got = model.module.backbone.encoderLayers[1].fnnBlockF(x_t)
    _close(got, want, dtype=torch.bfloat16)


def test_backbone_ctx_bf16_returns_fp32(models):
    p, model = models
    feats = np.random.default_rng(3).normal(size=(2, 126, 32, 3)).astype(np.float32)
    pitches = np.asarray(PITCHES, np.float32)
    backbone_j = JaxBackbone(
        input_size=3, base_size=8, pos_embed_init_gamma=1, n_head=2, hidden_factor=4,
        hidden_factor_attn=1, expansion_factor=2, n_layers=2, use_gradient_checkpoint=False,
        dtype=BF,
    )
    # jitted, as the JAX package's entry points run it
    want = jax.jit(lambda pp, f, pi: backbone_j.apply({"params": pp}, f, pi, True))(
        p["backbone"], jnp.asarray(feats), jnp.asarray(pitches))
    with torch.no_grad():
        got = model.module.backbone(torch.from_numpy(feats), torch.from_numpy(pitches))
    assert got.shape == (2, 90, 126, 16)
    _close(got, want, dtype=torch.float32)
    # the bf16 route is a different function from the fp32 one
    with torch.no_grad():
        fp32 = _port(TINY, {"params": p}, None).module.backbone(
            torch.from_numpy(feats), torch.from_numpy(pitches))
    assert float((got - fp32).abs().max()) > 1e-4


@pytest.mark.parametrize("method,t,t_pad", [("decode_scores", 21, 24), ("train_scores", 300, 304)])
def test_scorer_emits_bf16_scores(models, method, t, t_pad):
    """The score tensor is bf16 on both sides, NEG where padded, exactly;
    the real entries agree within SPACINGS spacings of the largest score
    (q, k and diag come from an fp32 map and are rounded; the products
    differ by summation order).  t = 300 exercises the rounded length
    factor: 259 is no bf16 value, and the entries at that distance are the
    rounded product times 260."""
    p, model = models
    scorer = model.module.scorer
    n, n_p, p_pad = 1, 5, 128
    ctx = np.random.default_rng(2).normal(size=(n, n_p, t, 16)).astype(np.float32)
    want = JaxScorer(16, 1, score_dtype=BF).apply(
        {"params": p["scorer"]}, jnp.asarray(ctx), t_pad, p_pad, method=getattr(JaxScorer, method))
    with torch.no_grad():
        got = getattr(scorer, method)(torch.from_numpy(ctx), t_pad, p_pad)
    s_t, s_j = got[0], _f32(want[0])
    assert s_t.dtype == torch.bfloat16 and want[0].dtype == BF and s_t.is_contiguous()
    s_t = _f32(s_t)
    padded = s_j < -1e29
    np.testing.assert_array_equal(s_t[padded], s_j[padded])
    assert not padded[:t, :t, :n_p].any() and padded.sum() == padded.size - t * t * n_p
    real = s_j[:t, :t, :n_p]
    assert np.abs(s_t[:t, :t, :n_p] - real).max() <= SPACINGS * BF16_SPACING * np.abs(real).max()
    # noise (and the diag that decode_scores returns) stay fp32
    assert got[1].dtype == torch.float32 and want[1].dtype == jnp.float32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if method == "decode_scores":
        assert got[2].dtype == torch.float32 and want[2].dtype == jnp.float32
        _close(got[2], want[2])
    else:
        with torch.no_grad():
            q, k, _ = scorer._qkd(torch.from_numpy(ctx))
        e, b = 280, 21  # |e - b| = 259 -> 260 in bf16
        assert float(torch.tensor(259.0).bfloat16()) == 260.0
        qk = (q[0, :, e].float() * k[0, :, b].float()).sum(-1).bfloat16()
        expect = (qk * torch.tensor(260.0).bfloat16()).float().numpy()
        # alpha layout [end, begin, lane]; the product's own rounding may
        # differ by one spacing from this sum's
        assert (np.abs(s_t[e, b, :n_p] - expect) <= BF16_SPACING * np.abs(expect) * 2).all()


def test_process_frames_decode_bf16(models):
    """The slice's device part as a whole, frames to decode-layout scores:
    ctx fp32 within SPACINGS, diag and scores within twice that (they are
    a further rounded product of the ctx)."""
    p, model = models
    frames = np.random.default_rng(4).normal(size=(1, 1, 126, 256)).astype(np.float32) * 0.1
    module_j = JaxModule(JaxModelConfig.from_dict(TINY), BF)
    s_j, noise_j, diag_j, ctx_j = jax.jit(  # jitted, as the JAX package's entry points run it
        lambda pp, f: module_j.apply({"params": pp}, f, 128, 128, True,
                                     method=JaxModule.process_frames_decode)
    )(p, jnp.asarray(frames))
    with torch.no_grad():
        s_t, noise, diag, ctx = model.module.process_frames_decode(torch.from_numpy(frames), 128, 128)
    assert s_t.is_contiguous() and noise.is_contiguous() and diag.is_contiguous()
    _close(ctx, ctx_j, dtype=torch.float32)
    _close(diag, diag_j, 2 * SPACINGS, dtype=torch.float32)
    _close(s_t[:126, :126, :90], s_j[:126, :126, :90], 2 * SPACINGS, dtype=torch.bfloat16)
    assert noise.dtype == torch.float32 and noise_j.dtype == jnp.float32


# -- the objective and its gradients --------------------------------------------------


def _batch(n=2, seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=(n, FS, 1)) * 0.1).astype(np.float32)
    notes = [
        [Note(0.1, 0.4, 60, 80), Note(0.45, 0.8, 60, 70), Note(0.2, 0.9, 64, 90),
         Note(0.0, 0.6, -64, 127, hasOnset=False)]
        for _ in range(n)
    ]
    return audio, notes


def test_log_prob_padded_and_grads_match_jax_at_bf16():
    """The per-track log-probability within 1e-3 of its largest magnitude
    (the fp32 test's bound: logZ and the path score are fp32 sums of the
    bf16 scores).  Parameter gradients, relative to each tensor's largest
    entry: weights within 0.04 of ``jax.grad`` at bf16 (5 bf16 spacings
    through a backward of bf16 products; measured 0.015).  A bias gradient
    is a sum of a bf16 cotangent over every position, which XLA on the CPU
    accumulates in bf16 and PyTorch in fp32, so the bf16 JAX value is itself
    off by up to 0.24 there; the port's is held against ``jax.grad`` at fp32
    instead, within 0.05 (measured 0.027), as every other gradient is too."""
    params = _jittered_params(TINY1, 64, 10)
    audio, notes = _batch()
    frames_j = jfrontend.make_frame(jnp.swapaxes(jnp.asarray(audio), -1, -2), 64, 256)
    labels = encode_batch(notes, 64 / FS, PITCHES, 8).astuple()
    conf_j = JaxModelConfig.from_dict(TINY1)

    def jax_grads(dtype):
        module_j = JaxTransKun(conf_j, compute_dtype=dtype).module

        def loss(p):
            logp = jax_log_prob_padded(module_j, p, frames_j, tuple(jnp.asarray(a) for a in labels))
            return -logp.sum(-1).mean() / 50.0, logp

        (_, logp), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        return logp, state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))

    logp_j, want_bf16 = jax_grads(BF)
    _, want_fp32 = jax_grads(None)

    model = _port(TINY1, params)
    model.module.eval()
    logp = log_prob_padded(model.module, model.frames(audio),
                           tuple(torch.from_numpy(a) for a in labels))
    assert logp.shape == (2, 90) and logp.dtype == torch.float32
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(logp_j), rtol=0,
                               atol=1e-3 * float(np.abs(np.asarray(logp_j)).max()))
    (-logp.sum(-1).mean() / 50.0).backward()
    got = {n: p.grad for n, p in model.module.named_parameters()}
    assert set(got) == set(want_bf16)
    for name, g in got.items():
        assert g.dtype == torch.float32  # parameters and their gradients stay fp32
        for want, rel in ((want_fp32, 0.05),) + (() if name.endswith(".bias") else ((want_bf16, 0.04),)):
            w = want[name].numpy()
            err = float(np.abs(g.numpy() - w).max()) / max(float(np.abs(w).max()), 1e-12)
            assert err <= rel, (name, err, rel)


def test_train_step_bf16_keeps_state_fp32_and_replays_dropout():
    """Loss, gradients, clip and optimizer state are fp32 at bf16, the
    state_dict keeps its fp32 entries and names, and a checkpointed layer
    replays the same casts and bf16 dropout masks: the same seed gives the
    same gradients with checkpointing on and off (bit for bit on the CPU,
    where the recompute repeats the same operations)."""
    from transkun_tpu_torch.train.optim import AdaBelief
    from transkun_tpu_torch.train.step import TrainState, make_train_step

    params = _jittered_params(TINY1, 64, 10)
    audio, notes = _batch(seed=1)
    conf = {**TINY1, "contextDropoutProb": 0.3}

    def grads(remat, seed):
        model = _port({**conf, "useGradientCheckpoint": remat}, params)
        logp = model.make_train_loss()(model.frames(audio), model.labels(notes, 8),
                                       torch.Generator().manual_seed(seed))
        (-logp.sum(-1).mean()).backward()
        return [p.grad.clone() for p in model.module.parameters()]

    on, off, other = grads(True, 7), grads(False, 7), grads(False, 8)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(off, other))  # dropout is on

    model = _port(TINY1, params)
    keys_fp32 = {k: v.dtype for k, v in _port(TINY1, params, None).module.state_dict().items()}
    state = TrainState(model, AdaBelief(model.module.named_parameters(), max_lr=2e-3,
                                        n_iter=100, warmup_cutoff=0))
    m = make_train_step(model)(state, model.frames(audio), model.labels(notes, 8),
                               torch.Generator().manual_seed(0))
    assert bool(m["finite"]) and m["loss"].dtype == m["grad_norm"].dtype == torch.float32
    assert {k: v.dtype for k, v in model.module.state_dict().items()} == keys_fp32
    assert set(keys_fp32.values()) == {torch.float32}
    assert all(v.dtype == torch.float32 for v in state.optimizer.mu.values())


# -- the slice as a whole ---------------------------------------------------------------


def test_transcribe_bf16_matches_jax_bf16():
    """Whole ``transcribe`` of a multi-segment piece, both packages at bf16
    on the same fp32 weights (a confident scorer, as in
    ``test_torch_transcribe.py``).  No exactness is demanded of notes at
    bf16: a Viterbi decision led by less than the bf16 score difference
    between the frameworks may flip (measured: 2 notes of 166 on each side;
    the JAX package's own fp32 and bf16 routes differ by 1).  At most 5% of
    the notes (pitch, velocity, times to the millisecond) may differ."""
    conf_j = JaxModelConfig.from_dict(TINY1)
    jax_model = JaxTransKun(conf_j, compute_dtype=BF)
    params = jax.jit(lambda k: jax_model.init(k, n_frames=126))(jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(lambda a: np.array(a), params)
    m = params["params"]["scorer"]["map"]
    e = m["kernel"].shape[1] // 2
    m["kernel"] *= 10.0
    m["bias"][0] += 6.0
    m["bias"][e] -= 6.0
    m["bias"][-1] = -8.0
    audio = _piece(dur=4.0)
    want = jax_model.transcribe(params, audio)
    got = _port(TINY1, params).transcribe(audio)

    def key(n):
        return (n.pitch, n.velocity, round(n.start * 1e3), round(n.end * 1e3))

    assert len(want) > 100
    differing = len({key(n) for n in got} ^ {key(n) for n in want})
    assert differing <= 0.05 * (len(got) + len(want)), (differing, len(got), len(want))


def _synth_corpus(root, dur=3.0):
    """One training and one validation piece in the MAESTRO layout, and
    their pickles; returns the pickle directory."""
    from transkun_tpu_torch.cli.create_dataset_maestro import main as create_dataset

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "2020"))
    rows = []
    for i, split in enumerate(["train", "validation"]):
        wav, mid = f"2020/p{i}.wav", f"2020/p{i}.midi"
        _synth_piece(rng, os.path.join(root, wav), os.path.join(root, mid), dur)
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"p{i}", "split": split,
                     "year": "2020", "midi_filename": mid, "audio_filename": wav, "duration": dur})
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    pickles = os.path.join(root, "pickles")
    create_dataset([root, meta, pickles])
    return pickles


def test_cli_train_and_transcribe_with_bf16(tmp_path, monkeypatch):
    """``cli.train --bf16 --device cpu`` takes steps with a stats decode and
    a validation, every score tensor that reaches the kernel wrappers is
    bf16, the checkpoint holds fp32 parameters under the reference's names,
    and ``cli.transcribe --bf16 --device cpu`` reads it and writes a MIDI
    file."""
    from transkun_tpu_torch.cli.train import main as train
    from transkun_tpu_torch.cli.transcribe import main as transcribe
    from transkun_tpu_torch.train import checkpoint as ckpt_mod

    root = str(tmp_path / "corpus")
    pickles = _synth_corpus(root)
    conf = tmp_path / "tiny.conf"
    conf.write_text(json.dumps({"Model": {"module": "transkun_tpu.models.transkun", "config": TINY1}}))
    ckpt = str(tmp_path / "ckpt.pt")

    seen = {"alpha": set(), "beta": set(), "viterbi": set()}
    for mod, name, tag in ((logz, "alpha_table_padded", "alpha"), (logz, "beta_table_padded", "beta"),
                           (semicrf, "viterbi_backward_tables_padded", "viterbi")):
        def record(s, *rest, _fn=getattr(mod, name), _tag=tag):
            seen[_tag].add(s.dtype)
            return _fn(s, *rest)

        monkeypatch.setattr(mod, name, record)

    record_run = train([
        ckpt, "--datasetPath", root,
        "--datasetMetaFile_train", os.path.join(pickles, "train.pickle"),
        "--datasetMetaFile_val", os.path.join(pickles, "val.pickle"),
        "--modelConf", str(conf), "--batchSize", "2", "--maxEvents", "8", "--statsEvery", "3",
        "--ckptEvery", "2", "--logEvery", "1", "--seed", "3", "--warmupCutoff", "0",
        "--nIter", "100", "--dataLoaderWorkers", "0", "--device", "cpu", "--bf16",
        "--maxEpoch", "1",
    ])
    assert record_run["steps"] >= 3 and record_run["stats_passes"] >= 1
    assert record_run["val_batches"] >= 1 and np.isfinite(record_run["losses"]).all()
    assert seen == {k: {torch.bfloat16} for k in seen}
    saved = ckpt_mod.load_checkpoint(ckpt)
    reference = TransKun(ModelConfig.from_dict(TINY1), device="cpu").module.state_dict()
    assert set(saved["state_dict"]) == set(reference)
    assert all(v.dtype == reference[k].dtype for k, v in saved["state_dict"].items())

    out = tmp_path / "out.mid"
    transcribe([os.path.join(root, "2020", "p1.wav"), str(out), "--conf", str(conf),
                "--weight", ckpt, "--device", "cpu", "--bf16"])
    assert out.exists()
