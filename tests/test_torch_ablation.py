"""The port's V1 model (``transkun_tpu_torch.models.ablation``) against the
JAX package's (``transkun_tpu.models.ablation``), on the CPU at the JAX
tests' TINY size (``tests/test_ablation.py``) with two GRU layers, as the
reference parity test has (``tests/test_ablation_parity.py``), so that the
stacked GRU and its conversion are covered.

The weights are drawn with numpy from a seed in the port's state_dict
layout and carried to the JAX package with ``convert_state_dict_ablation``.
Every bias is drawn, the GRU's two r and z biases too, so the conversion's
merge of them is exercised, and the running statistics are off their
initial values.  To make the decode neither empty nor full, the post-conv's
last weights are scaled by 10 and its biases set to -1.5 plus a N(0, 0.2)
draw per pitch: a few hundred notes on several pitches, no exact ties
between the continuous scores; the heads' last weights are scaled by 10 so
that velocities and refined times vary.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.data.labels import encode_batch as jax_encode_batch
from transkun_tpu.data.note import Note as JaxNote
from transkun_tpu.models.ablation import AblationConfig as JaxAblationConfig
from transkun_tpu.models.ablation import TransKunAblation as JaxTransKunAblation
from transkun_tpu.models.ablation import TransKunAblationModule as JaxModule
from transkun_tpu.ops import frontend as jfrontend
from transkun_tpu.ops import semicrf as jsemicrf
from transkun_tpu.train.optim import weight_decay_mask as jax_weight_decay_mask
from transkun_tpu.utils.torch_convert import convert_state_dict_ablation
from transkun_tpu_torch.data.note import Note
from transkun_tpu_torch.models import ablation
from transkun_tpu_torch.models.ablation import AblationConfig, TransKunAblation
from transkun_tpu_torch.models.config import parse_conf_file
from transkun_tpu_torch.ops import semicrf
from transkun_tpu_torch.train import checkpoint as ckpt_mod
from transkun_tpu_torch.train.optim import AdaBelief, weight_decay_mask
from transkun_tpu_torch.train.step import TrainState, make_train_step, saved_buffers
from transkun_tpu_torch.utils.convert import state_dict_from_flax_ablation

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


TINY = dict(
    f_min=30, f_max=1900, n_mels=32, hopSize=64, windowSize=256, fs=4000,
    nExtraWins=2,
    preConvSpec=[
        {"outputSize": 8, "hiddenSize": 8, "kernelSize": 3, "stride": (1, 2), "dropoutProb": 0.0},
        {"outputSize": 12, "hiddenSize": 12, "kernelSize": 3, "stride": (1, 2), "dropoutProb": 0.0},
    ],
    ctxSize=32, nLayersCtx=2, rnnHiddenSize=16, pitchEmbedSize=16,
    scoreDropoutProb=0.0, contextDropoutProb=0.0,
    velocityDropoutProb=0.0, refinedOFDropoutProb=0.0,
    segmentSizeInSecond=2.0, segmentHopSizeInSecond=1.0,
)
# the analysis windows' gradients against the JAX package's (see
# test_train_mode_statistics_loss_and_gradients_match_jax)
WINDOW_RTOL = 1e-3
NOTES = [
    [Note(0.1, 0.4, 60, 80), Note(0.5, 0.8, 64, 90)],
    [Note(0.2, 0.6, -64, 127), Note(0.3, 0.35, 21, 5)],
]


def _numpy_state_dict(module, seed):
    """A state_dict for ``module`` drawn with numpy (see the module
    docstring); the analysis windows keep their initial values."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            sd[name] = np.zeros(shape, np.int64)
            continue
        if "winGen" in name:
            a = t.numpy()
        elif name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif ".bn" in name and name.endswith(".weight"):
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif len(shape) == 1:
            a = 0.1 * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        sd[name] = a.astype(np.float32)
    sd["pairwiseScore.post.map.3.weight"] *= 10
    sd["pairwiseScore.post.map.3.bias"] = (
        -1.5 + 0.2 * np.random.default_rng(seed + 1).normal(size=90)).astype(np.float32)
    for head in ("velocityPredictor.6", "refinedOFPredictor.6"):
        sd[head + ".weight"] *= 10
    return sd

@pytest.fixture(scope="module")
def pair():
    """(port model on the CPU, JAX model, flax variables, numpy state_dict)."""
    model = TransKunAblation(AblationConfig.from_dict(TINY), device="cpu")
    sd = _numpy_state_dict(model.module, 0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jconf = JaxAblationConfig.from_dict(TINY)
    return model, JaxTransKunAblation(jconf), convert_state_dict_ablation(sd, jconf), sd


def _audio(seed, n=2, seconds=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, int(seconds * 4000), 1)) * 0.1).astype(np.float32)


def _jax_frames(audio):
    return jfrontend.make_frame(jnp.swapaxes(jnp.asarray(audio), -1, -2), 64, 256)


def _close(got, want, rtol, err=""):
    """|got - want| <= rtol * max(1, max |want|) over the whole tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (err, got.shape, want.shape)
    bound = rtol * max(1.0, float(np.abs(want).max(initial=0.0)))
    assert float(np.abs(got - want).max(initial=0.0)) <= bound, (err, float(np.abs(got - want).max()), bound)


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_config_and_conf_file_parse_to_the_port(tmp_path):
    assert AblationConfig().__dict__ == JaxAblationConfig().__dict__
    for name in ("transkun.Model_ablation", "transkun_tpu.models.ablation"):
        path = tmp_path / "v1.conf"
        path.write_text(json.dumps({"Model": {"module": name, "configClassName": "Config", "config": TINY}}))
        module, conf = parse_conf_file(str(path))
        assert module is ablation and isinstance(conf, AblationConfig)
        assert conf.ctxSize == 32 and conf.nLayersCtx == 2
    path.write_text(json.dumps({"Model": {"module": "transkun.Other", "config": {}}}))
    with pytest.raises(NotImplementedError):
        parse_conf_file(str(path))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a CUDA device")
def test_runs_on_the_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TransKunAblation(AblationConfig.from_dict(TINY))
    assert TransKunAblation(AblationConfig.from_dict(TINY), device="cpu", seed=0).device.type == "cpu"


def test_flax_variables_round_trip_through_the_state_dict(pair):
    """state_dict_from_flax_ablation is the inverse of the JAX package's
    converter, loads strictly into the port, and gives the GRU's merged r
    and z biases to ``bias_ih`` with ``bias_hh``'s r and z parts zero."""
    model, _, variables, _ = pair
    sd = state_dict_from_flax_ablation(variables)
    assert set(sd) == set(model.module.state_dict())
    back = convert_state_dict_ablation(sd, model.conf)
    want = dict(_tree_items(variables))
    got = dict(_tree_items(back))
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(v), err_msg=str(key))
    h = TINY["rnnHiddenSize"]
    assert not sd["contextModel.grus.bias_hh_l1_reverse"][: 2 * h].any()
    fresh = TransKunAblation(AblationConfig.from_dict(TINY), device="cpu")
    fresh.load_state_dict(sd)


def test_process_frames_matches_jax(pair):
    """ctx within 1e-5 * max(1, max |ctx|); s and the learned s_skip within
    1e-4 * max(1, max |s|); eval-mode BatchNorm on the running statistics."""
    model, jmodel, variables, _ = pair
    audio = _audio(1)
    fn = jax.jit(lambda v, f: jmodel.module.apply(v, f, True, method=JaxModule.process_frames))
    js, jskip, jctx = (np.asarray(a) for a in fn(variables, _jax_frames(audio)))
    with torch.no_grad():
        model.module.eval()
        s, skip, ctx = (a.numpy() for a in model.module.process_frames(model.frames(audio)))
    t = s.shape[0]
    assert s.shape == (t, t, 180) and skip.shape == (t - 1, 180) and ctx.shape == (2, t, 32)
    assert np.abs(jskip).max() > 0.1  # the learned skip score is not zero
    _close(ctx, jctx, 1e-5, "ctx")
    bound = max(1.0, float(np.abs(js).max()))
    _close(s / bound, js / bound, 1e-4, "s")
    _close(skip / bound, jskip / bound, 1e-4, "s_skip")


def test_train_mode_statistics_loss_and_gradients_match_jax(pair):
    """One train-mode objective (the JAX package's ``make_train_loss``
    through ``jax.value_and_grad``) against the port's ``make_train_loss``:
    the BatchNorm running statistics within 1e-6 * max(1, max |stat|) (a
    batch mean over the conv outputs, summed in another order), the per-track
    log-probability within 1e-4 relative, every parameter's gradient of
    -logp.sum(-1).mean() within 1e-4 * max(1, max |g|).  The torch GRU's
    r and z biases come in pairs that add, so each gets the gradient of
    flax's one bias.  The analysis windows' gradients sum the mel chain over
    every frame and bin, with cancellation: against the same objective
    evaluated in fp64 (the port's), the JAX package's fp32 values lie 6.8e-4
    (sigma) and 1.2e-4 (center) off in this bound's units, the port's 1.3e-4
    and 1.7e-5.  So they are held within WINDOW_RTOL of the JAX package's
    (the bound of the V2 gradient test, tests/test_torch_train.py) and
    within 2e-4 of the fp64 evaluation.  The conv biases, which a
    train-mode BatchNorm follows, have no gradient in exact arithmetic: both
    sides' values (rounding, up to 4.5e-3 in JAX's) are held within 1e-4 of
    their conv kernel's largest gradient (300 in the first block)."""
    model, jmodel, variables, sd = pair
    audio = _audio(2)
    labels = jax_encode_batch(
        [[JaxNote(n.start, n.end, n.pitch, n.velocity) for n in notes] for notes in NOTES],
        64 / 4000, jmodel.targetMIDIPitch, 8)
    jlabels = tuple(jnp.asarray(a) for a in labels.astuple())
    loss_fn = jmodel.make_train_loss(axis_name=None)

    def objective(params, frames):
        logp, mut = loss_fn({"params": params, "batch_stats": variables["batch_stats"]},
                            frames, jlabels, jax.random.PRNGKey(0))
        return -logp.sum(-1).mean(), (logp, mut)

    (_, (jlogp, mut)), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        variables["params"], _jax_frames(audio))

    module = model.module
    try:
        logp = model.make_train_loss()(model.frames(audio), model.labels(NOTES, 8), None)
        (-logp.sum(-1).mean()).backward()
        got_stats = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
        grads = {name: p.grad.numpy().copy() for name, p in module.named_parameters()}
        # the same objective with the frontend, CNN, GRU and scorer in fp64
        module.zero_grad(set_to_none=True)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        module.double()
        logp64 = model.make_train_loss()(model.frames(audio).double(), model.labels(NOTES, 8), None)
        (-logp64.sum(-1).mean()).backward()
        grads64 = {name: p.grad.numpy().copy() for name, p in module.named_parameters() if "winGen" in name}
    finally:
        module.zero_grad(set_to_none=True)
        module.float()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        module.eval()

    _close(logp.detach().numpy(), jlogp, 1e-4, "logp")
    want_stats = dict(_tree_items(mut["batch_stats"]))
    stats = dict(_tree_items(convert_state_dict_ablation(got_stats, model.conf)["batch_stats"]))
    assert set(stats) == set(want_stats)
    for key, want in want_stats.items():
        _close(stats[key], want, 1e-6, str(key))
        assert not np.allclose(stats[key], dict(_tree_items(variables["batch_stats"]))[key])

    h = TINY["rnnHiddenSize"]
    for name in list(grads):
        if ".bias_hh_l" in name:
            twin = grads[name.replace("bias_hh", "bias_ih")]
            _close(grads[name][: 2 * h], twin[: 2 * h], 1e-6, name)
            grads[name][: 2 * h] = 0.0  # the converter adds the pair
    grad_sd = {**{k: np.zeros_like(v) for k, v in got_stats.items()}, **grads}
    got = dict(_tree_items(convert_state_dict_ablation(grad_sd, model.conf)["params"]))
    want = dict(_tree_items(jgrads))
    assert set(got) == set(want)
    for key, g in want.items():
        if key[0].startswith("preLayer") and key[1].startswith("conv") and key[2] == "bias":
            # a bias under train-mode BatchNorm: 0 up to each side's rounding
            scale = max(1.0, float(np.abs(want[key[:2] + ("kernel",)]).max()))
            assert max(np.abs(got[key]).max(), np.abs(np.asarray(g)).max()) <= 1e-4 * scale, key
            continue
        _close(got[key], g, WINDOW_RTOL if key[0] == "frontend" else 1e-4, str(key))
    for name, g in grads64.items():
        _close(grads[name], g, 2e-4, name)


def test_log_prob_matches_jax(pair):
    """``log_prob`` (eval mode) within 1e-4 relative of the JAX package's."""
    model, jmodel, variables, _ = pair
    audio = _audio(3)
    jnotes = [[JaxNote(n.start, n.end, n.pitch, n.velocity) for n in notes] for notes in NOTES]
    want = np.asarray(jmodel.log_prob(variables, audio, jnotes, max_events=8))
    got = model.log_prob(audio, NOTES, max_events=8).detach().numpy()
    assert got.shape == (2, 90) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_viterbi_tables_exact_on_jax_scores(pair):
    """The JAX package's scores and learned skip score decode to the same
    pointer tables through the port's ``viterbi_backward_tables_best`` (the
    plain padded DP on a CPU tensor) as through its scan."""
    model, jmodel, variables, _ = pair
    fn = jax.jit(lambda v, f: jmodel.module.apply(v, f, True, method=JaxModule.process_frames))
    s, skip, _ = fn(variables, _jax_frames(_audio(4, n=1, seconds=1.3)))
    want_ptr, want_diag = jax.jit(jsemicrf.viterbi_backward_tables)(s, skip)
    ptr, diag = semicrf.viterbi_backward_tables_best(torch.tensor(np.asarray(s)),
                                                     torch.tensor(np.asarray(skip)))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(want_ptr))
    np.testing.assert_array_equal(diag.numpy(), np.asarray(want_diag))
    assert (ptr.numpy() >= 0).any() and diag.numpy().any() and not diag.numpy().all()


def test_transcribe_matches_jax(pair):
    """A 3.5 s piece in 1 s steps of 2 s segments: four full segments, a
    shorter one and a 0.46 s tail, stitched by forcedStartPos.  The notes
    equal the JAX package's: pitch and velocity, times within 1e-6 s."""
    model, jmodel, variables, _ = pair
    x = (np.random.default_rng(5).normal(size=(14000, 1)) * 0.05).astype(np.float32)
    want = jmodel.transcribe(variables, x, step_in_second=1.0, segment_size_in_second=2.0)
    got = model.transcribe(x, step_in_second=1.0, segment_size_in_second=2.0)
    assert 20 <= len(want) and len({n.pitch for n in want}) >= 3 and len({n.velocity for n in want}) >= 2
    assert len(got) == len(want)
    key = lambda n: (n.pitch, n.start)  # noqa: E731
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        assert (a.pitch, a.velocity) == (b.pitch, b.velocity)
        assert abs(a.start - b.start) <= 1e-6 and abs(a.end - b.end) <= 1e-6


def test_bf16_frontend_scores_and_notes_match_jax_bf16(pair):
    """Both packages' V1 at bf16 compute (the port's
    ``compute_dtype=torch.bfloat16``, the JAX package's ``jnp.bfloat16``),
    which rounds the mel frontend's windowed frames and DFT matrices to
    bf16 and leaves the rest fp32, on the weights of ``pair`` and the same
    numpy audio.  Bounds measured here (the fp32 route's in brackets):
    features within 5e-4 absolute, log-mel values up to 1.18 (measured
    1.1e-4, on 90 of 12288 entries above 1e-5; fp32 2.4e-7): where the two
    frameworks' fp32 windowed frames differ in the last bit, the rounding to
    bf16 can land one bf16 spacing apart, which the log of a small power
    magnifies; the bf16 rounding itself moves the features 1.3e-3 from the
    fp32 route's, more than the bound.  s and the learned s_skip within
    1e-4 * max(1, max |s|), the fp32 test's bound (measured 6e-7 and 2e-9).
    The notes of a 3.5 s piece equal, as at fp32: pitch and velocity, times
    within 1e-6 s (measured 194 notes, 9e-8 s)."""
    model32, _, variables, sd = pair
    conf = AblationConfig.from_dict(TINY)
    model = TransKunAblation(conf, device="cpu", compute_dtype=torch.bfloat16)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.module.eval()
    jmodel = JaxTransKunAblation(JaxAblationConfig.from_dict(TINY), compute_dtype=jnp.bfloat16)
    audio = _audio(1)
    frames = _jax_frames(audio)
    want_feat = np.asarray(jax.jit(lambda v, f: jmodel.module.apply(
        v, f, method=lambda m, x: m.frontend(x)))(variables, frames))
    fn = jax.jit(lambda v, f: jmodel.module.apply(v, f, True, method=JaxModule.process_frames))
    js, jskip, _ = (np.asarray(a) for a in fn(variables, frames))
    with torch.no_grad():
        model32.module.eval()
        feat = model.module.framewiseFeatureExtractor(model.frames(audio)).numpy()
        feat32 = model32.module.framewiseFeatureExtractor(model32.frames(audio)).numpy()
        s, skip, _ = (a.numpy() for a in model.module.process_frames(model.frames(audio)))
    assert feat.dtype == np.float32 and feat.shape == want_feat.shape
    assert np.abs(feat - want_feat).max() <= 5e-4
    assert np.abs(feat - feat32).max() > 5e-4  # the bf16 rounding is in force
    bound = max(1.0, float(np.abs(js).max()))
    _close(s / bound, js / bound, 1e-4, "s")
    _close(skip / bound, jskip / bound, 1e-4, "s_skip")

    x = (np.random.default_rng(5).normal(size=(14000, 1)) * 0.05).astype(np.float32)
    want = jmodel.transcribe(variables, x, step_in_second=1.0, segment_size_in_second=2.0)
    got = model.transcribe(x, step_in_second=1.0, segment_size_in_second=2.0)
    assert len(want) >= 20 and len(got) == len(want)
    key = lambda n: (n.pitch, n.start)  # noqa: E731
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        assert (a.pitch, a.velocity) == (b.pitch, b.velocity)
        assert abs(a.start - b.start) <= 1e-6 and abs(a.end - b.end) <= 1e-6


def test_weight_decay_mask_matches_jax(pair):
    """The port decays the same elements as the JAX package's optimizer
    (no bias decays, the GRU's included; BatchNorm scales do)."""
    model, _, variables, _ = pair
    mask = weight_decay_mask(model.module.named_parameters())
    port = sum(p.numel() for name, p in model.module.named_parameters() if mask[name])
    jmask = dict(_tree_items(jax_weight_decay_mask(variables["params"])))
    jax_count = sum(np.asarray(v).size for key, v in _tree_items(variables["params"]) if jmask[key])
    assert port == jax_count
    assert not mask["contextModel.grus.bias_ih_l0"] and mask["preLayer.layers.0.bn1.weight"]


def test_train_step_guard_keeps_the_running_statistics(pair):
    """A step whose loss is not finite leaves the parameters and the
    BatchNorm running statistics as they were; a finite one moves the
    statistics, and the buffers the guard keeps are exactly them."""
    model, _, _, sd = pair
    module = model.module
    names = [n for n in module.state_dict() if "running" in n or "num_batches" in n]
    assert len(saved_buffers(module)) == len(names) == 3 * 2 * len(TINY["preConvSpec"])
    try:
        opt = AdaBelief(module.named_parameters(), max_lr=2e-3, n_iter=100, warmup_cutoff=0)
        state = TrainState(model, opt)
        step = make_train_step(model)
        before = {k: v.clone() for k, v in module.state_dict().items()}
        frames = model.frames(_audio(6))
        labels = model.labels(NOTES, 8)
        bad = step(state, frames * float("nan"), labels, torch.Generator().manual_seed(0))
        assert not bool(bad["finite"])
        for k, v in module.state_dict().items():
            assert torch.equal(v, before[k]), k
        good = step(state, frames, labels, torch.Generator().manual_seed(0))
        assert bool(good["finite"])
        moved = module.state_dict()
        assert all(not torch.equal(moved[n], before[n]) for n in names)
    finally:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        module.eval()


def test_checkpoint_carries_the_running_statistics(pair, tmp_path):
    model, _, _, sd = pair
    opt = AdaBelief(model.module.named_parameters(), max_lr=2e-3, n_iter=100)
    path = str(tmp_path / "v1.pt")
    ckpt_mod.save_checkpoint(path, TrainState(model, opt, step=3))
    other = TransKunAblation(AblationConfig.from_dict(TINY), device="cpu", seed=1)
    state = TrainState(other, AdaBelief(other.module.named_parameters(), max_lr=2e-3, n_iter=100))
    ckpt_mod.restore_train_state(state, ckpt_mod.load_checkpoint(path))
    assert state.step == 3
    for name, v in sd.items():
        assert np.array_equal(other.module.state_dict()[name].numpy(), v), name


def test_stats_count_the_decoded_and_labelled_intervals(pair):
    """``compute_stats`` and ``compute_stats_mireval`` on the port's own
    decode: the counts of labelled intervals and decoded notes."""
    model, _, _, _ = pair
    audio = _audio(7)
    stats = model.compute_stats(audio, NOTES)
    assert stats["nGT"] == 4 and stats["nEst"] > 0 and stats["seVelocityForced"] == 0.0
    mir = model.compute_stats_mireval(audio, NOTES)
    notes, _ = model.transcribe_frames(model.frames(audio))
    assert mir["nGT"] == 4 and mir["nEst"] == sum(len(n) for n in notes) > 0
