"""The port's non-flagship V2 branches against the JAX package, at tiny
sizes on the CPU, with the weights carried by ``state_dict_from_flax``:

- ``BasicBlock`` with every ``enabled`` set of the JAX package's
  ``tests/test_layers_extra.py`` and ``("0All",)``: the aggregation-track
  ("All0", "0All") and full ("FT") attentions, within 1e-5 * max(1, max |y|)
  (fp32 sums in another order); the fused route (the plain versions on the
  CPU) gives the default route's result within the same bound, with the
  shapes the flagship hands the kernels;
- ``attention_plain`` and ``attention_bwd_plain`` at 1000 keys, past the
  general kernel's shared memory, against the JAX kernel in interpret mode
  (forward atol 2e-6, gradients 1e-5, as ``tests/test_torch_attention.py``);
- the backbone with ``downsampleF=False`` and with ``upsampleProjOnly=False``
  (ctx and scores within 1e-4, the bound of ``tests/test_torch_layers.py``),
  and the refusal of an expansion factor other than 1 that the JAX package
  asserts;
- V2 with the pairwise scorer at the JAX package's ``TINY`` of
  ``tests/test_v2_pairwise_scorer.py``: ``log_prob`` and every gradient
  within the bounds of ``tests/test_torch_ablation.py`` (1e-4; the analysis
  windows and the refined onset/offset head 1e-3, see
  ``test_pairwise_log_prob_and_gradients_match_jax``), and notes equal to
  the JAX package's on the device-walk route, the host-walk route and
  through ``transcribe_many``;
- conf files of the three configurations (aggregation tracks, full
  attention, pairwise V2) through ``parse_conf_file`` and the CLIs.
"""

import copy
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.data.note import Note as JaxNote
from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.backbone import Backbone as JaxBackbone
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.models.layers import BasicBlock as JaxBasicBlock
from transkun_tpu.models.transkun import TransKunModule as JaxModule
from transkun_tpu.models.transkun import log_prob_padded as jax_log_prob_padded
from transkun_tpu.ops import attention_pallas as ap
from transkun_tpu.ops import frontend as jfrontend
from transkun_tpu_torch.data.note import Note
from transkun_tpu_torch.models import layers
from transkun_tpu_torch.models.backbone import Backbone
from transkun_tpu_torch.models.config import ModelConfig, default_conf_path, parse_conf_file
from transkun_tpu_torch.models.transkun import TransKun, log_prob_padded
from transkun_tpu_torch.ops import attention as ta
from transkun_tpu_torch.utils.convert import state_dict_from_flax

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the JAX package's BasicBlock variants (tests/test_layers_extra.py) and 0All alone
ENABLED = [("F", "T"), ("F", "T", "All0", "0All"), ("FT",), ("F", "T", "All0"), ("0All",)]
BLOCK_RTOL = 1e-5
TOL = 1e-4
WINDOW_RTOL = 1e-3
# the refined onset/offset head's gradients (see
# test_pairwise_log_prob_and_gradients_match_jax); the bound of the flagship
# V2 gradient test, tests/test_torch_train.py
HEAD_RTOL = 1e-3
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": 4000, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 1.0,
    "segmentHopSizeInSecond": 0.5, "scoreDropoutProb": 0.0, "contextDropoutProb": 0.0,
    "velocityDropoutProb": 0.0, "refinedOFDropoutProb": 0.0,
}
# the three configurations, as changes to the flagship conf (2.0.conf)
BRANCHES = {
    "aggregation": {"enabledAttn": ["F", "T", "All0", "0All"]},
    "full": {"enabledAttn": ["FT"]},
    "pairwise": {"useInnerProductScorer": False, "upsampleProjOnly": False,
                 "scoringExpansionFactor": 1, "downsampleF": False},
}
PAIRWISE = {**TINY, "useInnerProductScorer": False}
NOTES = [[Note(0.1, 0.4, 60, 80), Note(0.5, 0.8, 64, 90)],
         [Note(0.2, 0.6, -64, 127), Note(0.3, 0.35, 21, 5)]]


def _close(got, want, rtol, err=""):
    """|got - want| <= rtol * max(1, max |want|) over the whole tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (err, got.shape, want.shape)
    bound = rtol * max(1.0, float(np.abs(want).max(initial=0.0)))
    assert float(np.abs(got - want).max(initial=0.0)) <= bound, (err, float(np.abs(got - want).max()), bound)


def _jitter(params, seed, amount=0.05):
    """Every leaf moved off its initial value, so that LayerScale and the
    zero biases let each branch show in the output."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=np.shape(a)) * amount).astype(np.float32), params)


def _block_state_dict(layer):
    """One flax encoder layer's params -> the port's BasicBlock state_dict
    (the mapping ``state_dict_from_flax`` applies under
    ``backbone.encoderLayers.i``)."""
    sd = {}
    for key, blk in layer.items():
        sd[f"{key}.scale"] = torch.tensor(np.asarray(blk["scale"]))
        if key.startswith("mhaBlock"):
            for proj in ("q_proj", "k_proj", "v_proj"):
                sd[f"{key}.module.{proj}_weight"] = torch.tensor(np.asarray(blk["mha"][proj]["kernel"]))
            lins = ((f"{key}.module.out_proj", blk["mha"]["out_proj"]),)
        else:
            lins = ((f"{key}.module.0", blk["lin1"]), (f"{key}.module.3", blk["lin2"]))
        for prefix, d in lins:
            sd[prefix + ".weight"] = torch.tensor(np.asarray(d["kernel"]).T)
            sd[prefix + ".bias"] = torch.tensor(np.asarray(d["bias"]))
    return sd


@pytest.mark.parametrize("enabled", ENABLED, ids="-".join)
def test_basic_block_matches_jax(enabled, monkeypatch):
    """Each branch against the JAX ``BasicBlock``, on the default route and
    on the fused route; the fused route hands the attention flat [B, S, D]
    tensors: "F" [N*T, F], "T" [N*F, T], "All0" the N*(F-1) tracks against
    track 0's row broadcast to each, "0All" [N, T] against [N, F*T], "FT"
    [N, F*T] against itself."""
    n, t, f, d = 2, 5, 7, 16
    x = np.random.default_rng(1).normal(size=(n, t, f, d)).astype(np.float32)
    jblock = JaxBasicBlock(size=d, num_heads=2, enabled=enabled, dropout=0.0)
    params = _jitter(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), True), 2)
    want = np.asarray(jblock.apply(params, jnp.asarray(x), True))
    block = layers.BasicBlock(d, 2, 2.0, 1.0, enabled)
    block.load_state_dict(_block_state_dict(params["params"]))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    _close(got.numpy(), want, BLOCK_RTOL, "default route")

    shapes = set()
    fused = ta.fused_attention

    def recorded(q, k, v, num_heads, scale):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return fused(q, k, v, num_heads, scale)

    monkeypatch.setenv("TRANSKUN_TPU_FUSED_ATTN", "1")
    monkeypatch.delenv("TRANSKUN_TPU_NO_PALLAS", raising=False)
    monkeypatch.setattr(ta, "fused_attention", recorded)
    with torch.no_grad():
        got_fused = block(torch.from_numpy(x))
    _close(got_fused.numpy(), got.numpy(), BLOCK_RTOL, "fused route")
    want_shapes = {
        "F": ((n * t, f, d), (n * t, f, d)), "T": ((n * f, t, d), (n * f, t, d)),
        "All0": ((n * (f - 1), t, d), (n * (f - 1), t, d)), "0All": ((n, t, d), (n, f * t, d)),
        "FT": ((n, f * t, d), (n, f * t, d)),
    }
    assert shapes == {want_shapes[tag] for tag in enabled}


def test_attention_plain_past_the_general_kernel_matches_jax_kernel():
    """1000 keys (the general kernel holds about 780 at head_dim 32): the
    plain versions the streaming kernels are held against, forward and
    backward, against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(3)
    b, sq, skv, h, dh = 2, 24, 1000, 2, 8
    q, k, v = (rng.normal(size=(b, s, h * dh)).astype(np.float32) for s in (sq, skv, skv))
    co = rng.normal(size=(b, sq, h * dh)).astype(np.float32)
    scale = 1.0 / np.sqrt(dh)
    ap.INTERPRET = True
    try:
        want, vjp = jax.vjp(lambda *a: ap.fused_attention(*a, h, scale), *map(jnp.asarray, (q, k, v)))
        want_grads = vjp(jnp.asarray(co))
    finally:
        ap.INTERPRET = False
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o = ta.attention_plain(tq, tk, tv, h, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-6)
    grads = ta.attention_bwd_plain(tq, tk, tv, o, torch.from_numpy(co), h, scale)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def _pair(conf_dict, seed, frames=66):
    """(JAX model, jittered flax params, the port's TransKun on the CPU with
    the same weights)."""
    jmodel = JaxTransKun(JaxModelConfig.from_dict(conf_dict))
    params = _jitter(jax.jit(lambda key: jmodel.init(key, n_frames=frames))(jax.random.PRNGKey(seed)), seed)
    model = TransKun(ModelConfig.from_dict(conf_dict), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return jmodel, params, model


def _audio(seed, n=1, seconds=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, int(seconds * 4000), 1)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("changes", [{"downsampleF": False},
                                     {"upsampleProjOnly": False, "scoringExpansionFactor": 1}],
                         ids=["downsampleF-False", "upsampleProjOnly-False"])
def test_backbone_variants_match_jax(changes):
    """ctx and the scores of ``process_frames`` against the JAX package's,
    every branch of the backbone in use (all four attentions)."""
    conf = {**TINY, "enabledAttn": ["F", "T", "All0", "0All"], **changes}
    jmodel, params, model = _pair(conf, 4)
    audio = _audio(5, n=2)
    frames = model.frames(audio)
    js, jnoise, jctx = jax.jit(lambda p, f: jmodel.module.apply(
        p, f, True, method=JaxModule.process_frames))(params, jnp.asarray(frames.numpy()))
    with torch.no_grad():
        s, noise, ctx = model.module.process_frames(frames)
    _close(ctx.numpy(), jctx, TOL, "ctx")
    bound = max(1.0, float(np.abs(np.asarray(js)).max()))
    _close(s.numpy() / bound, np.asarray(js) / bound, TOL, "s")
    assert not noise.any() and not np.asarray(jnoise).any()
    if not changes.get("upsampleProjOnly", True):
        assert "backbone.upConv1d.9.weight" in model.module.state_dict()


def test_upsample_stack_requires_expansion_one():
    """The JAX package asserts it (``models/backbone.py``); the port refuses
    the same configuration when it is built, with the same message."""
    kw = dict(input_size=3, base_size=8, n_head=2, expansion_factor=2, n_layers=1,
              upsample_proj_only=False)
    with pytest.raises(ValueError, match="requires expansion_factor == 1") as port_err:
        Backbone(**kw)
    bad = JaxBackbone(pos_embed_init_gamma=1.0, use_gradient_checkpoint=False, **kw)
    with pytest.raises(AssertionError) as jax_err:  # traced, not run
        jax.eval_shape(bad.init, jax.random.PRNGKey(0), jnp.zeros((1, 17, 32, 3)),
                       jnp.arange(21, 23, dtype=jnp.float32), True)
    assert str(port_err.value) == str(jax_err.value)
    Backbone(**{**kw, "expansion_factor": 1})


@pytest.fixture(scope="module")
def pairwise():
    """The pairwise-scorer V2 at the JAX package's TINY; the post-conv's
    last bias lowered so that 0.5% of a segment's singletons fire on random
    weights."""
    jmodel = JaxTransKun(JaxModelConfig.from_dict(PAIRWISE))
    params = _jitter(jax.jit(lambda key: jmodel.init(key, n_frames=66))(jax.random.PRNGKey(0)), 7, 0.02)
    params = copy.deepcopy(params)
    frames = jax.numpy.swapaxes(jnp.asarray(_audio(8)), -1, -2)
    s = jax.jit(lambda p, f: jmodel.module.apply(p, f, True, method=JaxModule.process_frames)[0])(
        params, jfrontend.make_frame(frames, 64, 256))
    post = params["params"]["scorer"]["post"]["conv2"]
    post["bias"] = np.asarray(post["bias"]) - np.float32(np.quantile(np.diagonal(np.asarray(s)), 0.995))
    model = TransKun(ModelConfig.from_dict(PAIRWISE), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return jmodel, params, model


def test_pairwise_log_prob_and_gradients_match_jax(pairwise):
    """``log_prob_padded`` on the unfused route: the per-track
    log-probability within 1e-4 * max(1, max |logp|) and every parameter's
    gradient of -logp.sum(-1).mean() within 1e-4 * max(1, max |g|), the
    analysis windows within 1e-3 (tests/test_torch_ablation.py's bounds);
    the learned skip score reaches logZ (its gradient is not zero).

    The refined onset/offset head (``refinedOFPredictor``) is held within
    1e-3: one event's of_value logit here is 0.0103, just outside the
    continuous Bernoulli's Taylor window (|l| <= 8e-3), where the exact
    log-normalizer subtracts terms near 1/|l|.  There the fp32 gradient of
    the log-probability in the logit is 2.6e-4 off its fp64 value in both
    packages (measured on this fixture: torch 2.555e-4, JAX 2.556e-4), and
    the two differ by 1.3e-4 in the head's last bias gradient.  The formula
    is the JAX package's own (``ops/distributions.py``), copied."""
    from transkun_tpu.data.labels import encode_batch

    jmodel, params, model = pairwise
    audio = _audio(6, n=2)
    jnotes = [[JaxNote(n.start, n.end, n.pitch, n.velocity) for n in notes] for notes in NOTES]
    jlabels = tuple(jnp.asarray(a) for a in encode_batch(jnotes, 64 / 4000, jmodel.targetMIDIPitch, 8).astuple())
    frames = model.frames(audio)

    def objective(p):
        logp = jax_log_prob_padded(jmodel.module, p, jnp.asarray(frames.numpy()), jlabels)
        return -logp.sum(-1).mean(), logp

    (_, jlogp), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
    module = model.module
    try:
        logp = log_prob_padded(module, frames, model.labels(NOTES, 8))
        (-logp.sum(-1).mean()).backward()
        grads = {name: p.grad.numpy().copy() for name, p in module.named_parameters()}
    finally:
        module.zero_grad(set_to_none=True)
    _close(logp.detach().numpy(), jlogp, TOL, "logp")
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for name, g in want.items():
        rtol = WINDOW_RTOL if "winGen" in name else HEAD_RTOL if "refinedOF" in name else TOL
        _close(grads[name], g.numpy(), rtol, name)
    assert np.abs(grads["scorer.scoreMapSkip.6.bias"]).max() > 0


def _same_notes(got, want):
    """Pitch, velocity and flags equal, times within 1e-6 s, pitch by pitch
    (times that differ in their last bits may reorder notes of different
    pitch that start together)."""
    assert len(got) == len(want) and len(got) > 0
    key = lambda n: (n.pitch, n.start)
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        assert (a.pitch, a.velocity, a.hasOnset, a.hasOffset) == (b.pitch, b.velocity, b.hasOnset, b.hasOffset)
        assert abs(a.start - b.start) <= 1e-6 and abs(a.end - b.end) <= 1e-6


def test_pairwise_transcribe_routes_match_jax(pairwise):
    """A 2.6 s piece in 0.5 s steps of 1 s segments, groups of 2: the
    device-walk route (the default), the host-walk route (a budget of 1),
    and ``transcribe_many`` over two copies give the JAX package's notes."""
    jmodel, params, model = pairwise
    audio = _audio(8, seconds=2.6)[0]
    want = jmodel.transcribe(params, audio)
    got = model.transcribe(audio, segment_batch=2)
    assert model.last_transcribe_fallback_from is None
    _same_notes(got, want)
    model.decode_k_budget = 1
    try:
        host = model.transcribe(audio, segment_batch=2)
        assert model.last_transcribe_fallback_from == 0
    finally:
        model.decode_k_budget = None
    _same_notes(host, want)
    for notes in model.transcribe_many([audio, audio], segment_batch=2):
        _same_notes(notes, want)


def _conf_file(path, config):
    path.write_text(json.dumps({"Model": {"module": "transkun_tpu.models.transkun",
                                          "configClassName": "Config", "config": config}}))
    return str(path)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_confs_load_at_flagship_width(branch, tmp_path):
    """Each configuration, the flagship conf with the branch's changes,
    parses to the port's V2 module and builds at full width."""
    with open(default_conf_path()) as f:
        flagship = json.load(f)["Model"]["config"]
    module, conf = parse_conf_file(_conf_file(tmp_path / f"{branch}.conf", {**flagship, **BRANCHES[branch]}))
    for key, value in BRANCHES[branch].items():
        assert getattr(conf, key) == (tuple(value) if isinstance(value, list) else value)
    model = module.TransKun(conf, device="cpu", seed=0)
    names = model.module.state_dict()
    if branch == "aggregation":
        assert "backbone.encoderLayers.5.mhaBlockAll0.scale" in names
    elif branch == "full":
        assert "backbone.encoderLayers.5.fnnBlockFT.scale" in names
    else:
        assert "scorerProj.weight" in names and "backbone.upConv1d.0.weight" in names


def test_branch_confs_run_through_the_clis(tmp_path):
    """The three configurations at TINY width through the trainer's
    ``--modelConf`` (two steps each on a two-piece corpus) and the
    transcriber's ``--conf`` with the trained weights."""
    from scipy.io import wavfile

    from transkun_tpu_torch.cli.create_dataset_maestro import main as create_dataset
    from transkun_tpu_torch.cli.train import main as train
    from transkun_tpu_torch.cli.transcribe import main as transcribe
    from transkun_tpu_torch.data.midi import write_midi

    root = tmp_path / "corpus"
    os.makedirs(root / "2020")
    rng = np.random.default_rng(0)
    rows = []
    for i, split in enumerate(["train", "validation"]):
        wav, mid = f"2020/p{i}.wav", f"2020/p{i}.midi"
        x = rng.normal(size=8000) * 0.05
        wavfile.write(str(root / wav), 4000, (x * 32767).astype(np.int16))
        write_midi([Note(0.2, 0.6, 60, 80), Note(0.9, 1.5, 64, 70)], str(root / mid))
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"p{i}", "split": split,
                     "year": "2020", "midi_filename": mid, "audio_filename": wav, "duration": 2.0})
    with open(root / "meta.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    create_dataset([str(root), str(root / "meta.csv"), str(tmp_path / "pickles")])
    for branch, changes in BRANCHES.items():
        conf = _conf_file(tmp_path / f"{branch}.conf", {**TINY, **changes})
        ckpt = str(tmp_path / f"{branch}.pt")
        run = train([ckpt, "--datasetPath", str(root),
                     "--datasetMetaFile_train", str(tmp_path / "pickles" / "train.pickle"),
                     "--datasetMetaFile_val", str(tmp_path / "pickles" / "val.pickle"),
                     "--modelConf", conf, "--batchSize", "2", "--maxEvents", "8", "--statsEvery", "0",
                     "--logEvery", "1", "--seed", "3", "--maxEpoch", "1", "--stopAtStep", "2",
                     "--dataLoaderWorkers", "0", "--device", "cpu"])
        assert run["steps"] == 2 and np.isfinite(run["losses"]).all(), branch
        out = tmp_path / f"{branch}.mid"
        transcribe([str(root / "2020" / "p1.wav"), str(out), "--conf", conf, "--weight", ckpt,
                    "--device", "cpu"])
        assert out.exists(), branch
