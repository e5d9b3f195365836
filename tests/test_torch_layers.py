"""The port's V2 layers against the flax modules, with the same weights
carried across by ``state_dict_from_flax``: one axial ``BasicBlock``, the
scorer's decode-layout scores, the ``Backbone`` ctx and the whole
``process_frames_decode`` chain.  fp32 throughout; the tolerance is 1e-4
(sums in another order and exact-erf GELU from two libraries), relative to
the magnitude for the length-scaled scores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.backbone import Backbone as JaxBackbone
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.models.layers import BasicBlock as JaxBasicBlock
from transkun_tpu.models.layers import ScaledInnerProductIntervalScorer as JaxScorer
from transkun_tpu.models.transkun import TransKunModule as JaxModule
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun, target_midi_pitches
from transkun_tpu_torch.utils.convert import state_dict_from_flax

TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": 4000, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 2,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0,
    "segmentHopSizeInSecond": 1.0,
}
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """(flax params with every leaf jittered off its init, the port's
    TransKun holding the same weights)."""
    conf = JaxModelConfig.from_dict(TINY)
    jax_model = JaxTransKun(conf)
    params = jax.jit(lambda k: jax_model.init(k, n_frames=126))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)

    def jitter(a):
        a = np.asarray(a)
        return a + (rng.normal(size=a.shape) * 0.05).astype(a.dtype)

    params = jax.tree_util.tree_map(jitter, params)
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return params["params"], model


def _close(got: torch.Tensor, want, scale=1.0):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL * scale, rtol=TOL)


def test_basic_block(models):
    p, model = models
    module = model.module
    x = np.random.default_rng(1).normal(size=(2, 7, 11, 32)).astype(np.float32)
    want = JaxBasicBlock(size=32, num_heads=2, hidden_factor=4, hidden_factor_attn=1,
                         enabled=("F", "T")).apply(
        {"params": p["backbone"]["encoderLayers_1"]}, jnp.asarray(x), True
    )
    with torch.no_grad():
        got = module.backbone.encoderLayers[1](torch.from_numpy(x))
    _close(got, want)


def test_decode_scores(models):
    p, model = models
    module = model.module
    n, t, t_pad, p_pad = 2, 21, 24, 64
    ctx = np.random.default_rng(2).normal(size=(n, 37, t, 16)).astype(np.float32)
    s_j, noise_j, diag_j = JaxScorer(16, 1).apply(
        {"params": p["scorer"]}, jnp.asarray(ctx), t_pad, p_pad, method=JaxScorer.decode_scores
    )
    with torch.no_grad():
        s_t, noise, diag = module.scorer.decode_scores(torch.from_numpy(ctx), t_pad, p_pad)
    _close(s_t, s_j, scale=float(np.abs(np.asarray(s_j)[:t, :t]).max()))
    assert (s_t.numpy() == np.asarray(s_j)).reshape(-1)[np.asarray(s_j).reshape(-1) < -1e29].all()
    _close(noise, noise_j)
    _close(diag, diag_j)


def test_backbone_ctx(models):
    p, model = models
    module = model.module
    feats = np.random.default_rng(3).normal(size=(2, 126, 32, 3)).astype(np.float32)
    pitches = np.asarray(target_midi_pitches(), np.float32)
    want = JaxBackbone(
        input_size=3, base_size=8, pos_embed_init_gamma=1, n_head=2, hidden_factor=4,
        hidden_factor_attn=1, expansion_factor=2, n_layers=2, use_gradient_checkpoint=False,
    ).apply({"params": p["backbone"]}, jnp.asarray(feats), jnp.asarray(pitches), True)
    with torch.no_grad():
        got = module.backbone(torch.from_numpy(feats), torch.from_numpy(pitches))
    assert got.shape == (2, 90, 126, 16)
    _close(got, want)


def test_process_frames_decode(models):
    p, model = models
    module = model.module
    frames = np.random.default_rng(4).normal(size=(1, 1, 126, 256)).astype(np.float32) * 0.1
    conf = JaxModelConfig.from_dict(TINY)
    s_j, noise_j, diag_j, ctx_j = JaxModule(conf).apply(
        {"params": p}, jnp.asarray(frames), 128, 128, True,
        method=JaxModule.process_frames_decode,
    )
    with torch.no_grad():
        s_t, noise, diag, ctx = module.process_frames_decode(torch.from_numpy(frames), 128, 128)
    # the Viterbi kernel takes contiguous tensors only
    assert s_t.is_contiguous() and noise.is_contiguous() and diag.is_contiguous()
    assert (diag * (diag > 0)).is_contiguous()
    _close(ctx, ctx_j)
    _close(diag, diag_j)
    _close(noise, noise_j)
    _close(s_t, s_j, scale=float(np.abs(np.asarray(s_j)[:126, :126, :90]).max()))


@pytest.mark.parametrize("criterion", ["hamming", "mse", "match", "mae"])
def test_attribute_readout(models, criterion):
    """Attribute heads and the velocity criteria on gathered endpoint
    contexts: integer velocities and presence bits equal, the refined
    onset/offset and the "mse" velocity within TOL."""
    p, model = models
    rng = np.random.default_rng(6)
    ctx = rng.normal(size=(2, 90, 40, 16)).astype(np.float32)
    begins = np.sort(rng.integers(0, 40, size=(2, 90, 2, 4)), axis=2)
    begins, ends = begins[:, :, 0], begins[:, :, 1]
    jax_model = JaxTransKun(JaxModelConfig.from_dict(TINY))
    want = jax_model._attr_readout(
        {"params": p}, jnp.asarray(ctx), jnp.asarray(begins), jnp.asarray(ends), criterion
    )
    with torch.no_grad():
        got = model._attr_readout(
            torch.from_numpy(ctx), torch.from_numpy(begins), torch.from_numpy(ends), criterion
        )
    if criterion == "mse":
        _close(got[0], want[0], scale=128)
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
