"""The port's data parallelism on the CPU: two gloo ranks, as a pair of
subprocesses (``tests/_torch_dist_ranks.py``), against the JAX package's
mesh step on the same two shards in this process (``make_mesh(2)`` over the
virtual CPU devices of ``tests/conftest.py``).

Tolerances are ``tests/test_torch_train.py``'s: the loss, grad norm and clip
value of each step within rtol 1e-5, and the parameters after each step
within rtol 1e-5 and 1e-7 absolute (its optimizer-parity bounds), the first
moment (the clipped summed gradient) within 1e-3 of each tensor's largest
value (its gradient bound); the ranks' parameters equal bit for bit.  The V1 BatchNorm running statistics
within rtol 1e-4 and 1e-6 absolute of a one-process step on the
concatenated batch and of the JAX package's two-shard step (the bounds of
``tests/test_ablation_train.py::test_v1_dp_syncbn_matches_single_device_stats``);
the V1 summed gradient within 1e-3 of each tensor's largest value of twice
the concatenated batch's (the gradient bound), the conv biases that a
train-mode BatchNorm follows within 1e-4 of their kernel's largest gradient
(``tests/test_torch_ablation.py``'s rule: no gradient in exact arithmetic).
"""

import re
import sys
import time

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from transkun_tpu.data.labels import encode_batch as jax_encode_batch
from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.ablation import AblationConfig as JaxAblationConfig
from transkun_tpu.models.ablation import TransKunAblation as JaxTransKunAblation
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.ops import frontend as jfrontend
from transkun_tpu.parallel import make_mesh
from transkun_tpu.train import init_train_state, make_optimizer, make_train_step as jax_make_train_step
from transkun_tpu.train.validate import _metrics_from_agg as jax_metrics_from_agg
from transkun_tpu.utils.torch_convert import convert_state_dict, convert_state_dict_ablation
from transkun_tpu_torch.models.ablation import AblationConfig, TransKunAblation
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun
from transkun_tpu_torch.train.optim import AdaBelief
from transkun_tpu_torch.train.step import TrainState, dropout_seed, make_train_step
from transkun_tpu_torch.train.validate import AGG_KEYS, _metrics_from_agg
from transkun_tpu_torch.utils.convert import state_dict_from_flax

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PITCHES = [-64, -67] + list(range(21, 109))


def _jax_inputs(step, max_events):
    audio, notes = ranks.batch(step)
    frames = jfrontend.make_frame(jax.numpy.swapaxes(jax.numpy.asarray(audio), -1, -2), 64, 256)
    labels = jax_encode_batch(notes, 64 / ranks.FS, PITCHES, max_events)
    return frames, tuple(jax.numpy.asarray(a) for a in labels.astuple())


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    """Numpy-perturbed flax params of the tiny V2 model, the two ranks'
    results and the JAX mesh step's (metrics, params, first moment) after
    each step: STEPS from the optimizer's count 0, then one from
    ``OPT_COUNT``, as the ranks take them."""
    tmp = tmp_path_factory.mktemp("v2")
    jmodel = JaxTransKun(JaxModelConfig.from_dict(ranks.V2_CONF))
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32),
        jax.jit(lambda k: jmodel.init(k, n_frames=64))(jax.random.PRNGKey(0)))
    torch.save({"state_dict": state_dict_from_flax(params)}, tmp / "in.pt")
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    ranks.run_pair("v2", str(tmp / "in.pt"), outs)
    got = [torch.load(p, weights_only=False) for p in outs]

    opt = make_optimizer(params["params"], **ranks.OPTIMIZER)
    step = jax_make_train_step(jmodel.module, opt, mesh=make_mesh(2))
    state = init_train_state(jax.tree_util.tree_map(jax.numpy.asarray, params), opt)
    want = []
    for k in range(ranks.STEPS + 1):
        if k == ranks.STEPS:
            state = state._replace(opt_state=_with_count(state.opt_state, ranks.OPT_COUNT))
        state, m = step(state, *_jax_inputs(k, ranks.MAX_EVENTS), jax.random.PRNGKey(k))
        mu = {"params": jax.tree_util.tree_map(np.asarray, state.opt_state[0].mu)}
        want.append(({n: float(v) for n, v in m.items()},
                     state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params)),
                     state_dict_from_flax(mu)))
    return got, want, state_dict_from_flax(params), params


def _with_count(opt_state, count):
    """``make_optimizer``'s state with both its counts set (as
    ``tests/test_torch_train.py`` sets them)."""
    count = jax.numpy.int32(count)
    return (opt_state[0]._replace(count=count), opt_state[1], opt_state[2]._replace(count=count))


def _to_flax(state_dict):
    """A port V2 state_dict of numpy arrays or tensors -> the flax params
    tree (the JAX package's converter; the upsample bias, [8*out] on both
    sides, kept as it is rather than tiled as a reference [out] bias)."""
    tree = convert_state_dict(dict(state_dict), JaxModelConfig.from_dict(ranks.V2_CONF))["params"]
    tree["backbone"]["upConv1dSkip"]["bias"] = np.asarray(state_dict["backbone.upConv1dSkip.bias"])
    return tree


def _assert_state_close(got, want, rtol=1e-5, atol=1e-7):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), rtol=rtol, atol=atol, err_msg=name)


def _assert_moment_close(got, want):
    """Within the gradient bound: 1e-3 of each tensor's largest value."""
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-12), err_msg=name)


@pytest.mark.parametrize("step", range(ranks.STEPS))
def test_two_rank_step_matches_jax_mesh_step(v2, step):
    """Gradients summed over the two ranks, as the JAX mesh step's psum:
    the metrics, every parameter and the first moment (the clipped summed
    gradient, within the gradients' bound) agree.  The optimizer starts at
    count 0, so its rectification gate holds the parameters still
    (``test_step_past_the_gate_matches_jax`` takes the step that moves
    them)."""
    got, want, _, _ = v2
    want_metrics, want_params, want_mu = want[step]
    assert want_metrics["finite"] == 1.0
    for r in range(2):
        m = got[r]["metrics"][step]
        for key in ("loss", "grad_norm", "clip_value"):
            np.testing.assert_allclose(m[key], want_metrics[key], rtol=1e-5, err_msg=key)
        assert m["finite"] == 1.0
        _assert_state_close(got[r]["params"][step], want_params)
        _assert_moment_close(got[r]["mu"][step], want_mu)


def test_step_past_the_gate_matches_jax(v2):
    """The step from count OPT_COUNT, past the rectification gate: its
    metrics and first moment agree with the JAX mesh step's, as the steps
    before; the parameters it moved, and both moments, agree with the JAX
    package's optimizer (``make_optimizer``) taking the same step from the
    ranks' own state and clipped summed gradient, within the
    optimizer-parity bounds.  The parameters are not held to the JAX mesh
    step's directly: past the gate AdaBelief divides each entry's moment by
    its own root variance, so an entry whose gradient lies near 0 (within
    the gradients' 1e-3 bound of each tensor's largest) moves by an amount
    that bound does not limit (on this data 11 of refinedOFPredictor's 24576
    first-layer weights, 9.3e-7 apart)."""
    got, want, _, params = v2
    k = ranks.STEPS
    want_metrics, _, want_mu = want[k]
    assert want_metrics["finite"] == 1.0
    opt = make_optimizer(params["params"], **ranks.OPTIMIZER)
    for r in range(2):
        m = got[r]["metrics"][k]
        for key in ("loss", "grad_norm", "clip_value"):
            np.testing.assert_allclose(m[key], want_metrics[key], rtol=1e-5, err_msg=key)
        assert m["finite"] == 1.0
        _assert_moment_close(got[r]["mu"][k], want_mu)

        p0 = _to_flax(got[r]["params"][k - 1])
        st = opt.init(p0)
        st = _with_count((st[0]._replace(mu=_to_flax(got[r]["mu"][k - 1]), nu=_to_flax(got[r]["nu"][k - 1])),
                          st[1], st[2]), ranks.OPT_COUNT)
        upd, st = opt.update(_to_flax(got[r]["clipped"][k]), st, p0)
        p1 = jax.tree_util.tree_map(lambda a, b: np.asarray(a + b), p0, upd)
        _assert_state_close(got[r]["params"][k], state_dict_from_flax({"params": p1}))
        for key, tree in (("mu", st[0].mu), ("nu", st[0].nu)):
            _assert_state_close(got[r][key][k], state_dict_from_flax(
                {"params": jax.tree_util.tree_map(np.asarray, tree)}))
        before = got[r]["params"][k - 1]
        moved = [n for n, v in got[r]["params"][k].items() if not torch.equal(v, before[n])]
        assert len(moved) == len(before)


def test_ranks_hold_the_same_bits(v2):
    """The ranks' parameters and moments after each step are equal bit for
    bit, and so are they after the step past the rectification gate, which
    moved them."""
    got = v2[0]
    for step in range(ranks.STEPS + 1):
        for key in ("params", "mu", "nu", "clipped"):
            a, b = got[0][key][step], got[1][key][step]
            assert all(torch.equal(a[k], b[k]) for k in a)
        assert got[0]["metrics"][step] == got[1]["metrics"][step]
    a, before = got[0]["params"][ranks.STEPS], got[0]["params"][ranks.STEPS - 1]
    moved = [k for k in a if not torch.equal(a[k], before[k])]
    assert len(moved) > len(a) // 2


def test_gradients_summed_not_averaged(v2):
    """The first step's grad norm (before the clip) is the norm of the sum
    of the two halves' gradients, each of its half's mean loss, computed
    here in one process: twice the concatenated batch's."""
    got, _, state_dict, _ = v2
    model = TransKun(ModelConfig.from_dict(ranks.V2_CONF), device="cpu")
    model.load_state_dict(state_dict)
    audio, notes = ranks.batch(0)
    loss_fn = model.make_train_loss()

    def grads(rows):
        model.module.zero_grad(set_to_none=True)
        logp = loss_fn(model.frames(audio[rows]), model.labels(notes[rows], 16), None)
        (-logp.sum(-1).mean() / 50.0).backward()
        return [p.grad.clone() for p in model.module.parameters()]

    halves = [a + b for a, b in zip(grads(slice(0, 2)), grads(slice(2, 4)))]
    whole = grads(slice(0, 4))
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in halves)))
    norm_whole = float(torch.sqrt(sum((g.double() ** 2).sum() for g in whole)))
    np.testing.assert_allclose(got[0]["metrics"][0]["grad_norm"], norm, rtol=1e-5)
    np.testing.assert_allclose(norm, 2 * norm_whole, rtol=1e-5)


def test_k_sync_agrees_across_ranks(v2):
    """Rank 1's chunk has a 12-note track (K grows to 16 alone); with
    ``k_sync`` (an all-reduce MAX) both ranks grow to 16, as the JAX
    package's one encoding of the global batch does."""
    got = v2[0]
    assert [got[r]["k_local"] for r in range(2)] == [ranks.MAX_EVENTS, 16]
    assert [got[r]["k_synced"] for r in range(2)] == [16, 16]
    want_k = jax_encode_batch(ranks.batch(0)[1], 64 / ranks.FS, PITCHES, ranks.MAX_EVENTS).begins.shape[-1]
    assert got[0]["k"] == got[1]["k"] == [want_k] * (ranks.STEPS + 1)


def test_validation_counts_summed_across_ranks(v2):
    """``aggregate_across_processes`` sums the 5-vectors in float64 on every
    rank: the JAX package's sum of the gathered vectors, and the same
    metrics from it."""
    got = v2[0]
    want = dict(zip(AGG_KEYS, np.asarray(ranks.VAL_COUNTS, np.float64).sum(axis=0).tolist()))
    for r in range(2):
        assert got[r]["aggregate"] == want
    assert _metrics_from_agg(got[0]["aggregate"]) == jax_metrics_from_agg(want)


def _stats(state_dict, jconf):
    tree = convert_state_dict_ablation({k: v.numpy() for k, v in state_dict.items()}, jconf)
    return jax.tree_util.tree_flatten_with_path(tree["batch_stats"])[0]


@pytest.fixture(scope="module")
def v1(tmp_path_factory):
    """The two ranks' results of one V1 step, and the one-process model
    they started from (``seed=0``)."""
    tmp = tmp_path_factory.mktemp("v1")
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    ranks.run_pair("v1", str(tmp / "none.pt"), outs)
    return [torch.load(p, weights_only=False) for p in outs]


def _v1_model():
    return TransKunAblation(AblationConfig.from_dict(ranks.V1_CONF), device="cpu", seed=0)


def test_v1_syncbn_sums_statistics_across_ranks(v1):
    """One two-rank V1 step: the BatchNorm running statistics equal a
    one-process port step's on the concatenated batch, and the JAX
    package's two-shard step's; the ranks' parameters hold the same bits."""
    got = v1
    a, b = got[0]["state_dict"], got[1]["state_dict"]
    assert all(torch.equal(a[k], b[k]) for k in a)

    model = _v1_model()
    sd = {k: v.numpy().copy() for k, v in model.module.state_dict().items()}
    moved = [k for k in sd if "weight" in k and not np.array_equal(a[k].numpy(), sd[k])]
    assert len(moved) > len(sd) // 4
    audio, notes = ranks.batch(0)
    one = make_train_step(model)(TrainState(model, AdaBelief(model.module.named_parameters(),
                                                              **ranks.OPTIMIZER)),
                                 model.frames(audio), model.labels(notes, 16), None)
    np.testing.assert_allclose(got[0]["metrics"]["loss"], float(one["loss"]), rtol=1e-4)

    jconf = JaxAblationConfig.from_dict(ranks.V1_CONF)
    jmodel = JaxTransKunAblation(jconf)
    variables = convert_state_dict_ablation(sd, jconf)
    opt = make_optimizer(variables["params"], **ranks.OPTIMIZER)
    step = jax_make_train_step(None, opt, mesh=make_mesh(2), loss_fn=jmodel.make_train_loss(axis_name="dp"))
    state, _ = step(init_train_state(variables, opt), *_jax_inputs(0, 16), jax.random.PRNGKey(0))
    want_jax = jax.tree_util.tree_flatten_with_path(state.params["batch_stats"])[0]

    got_stats = _stats(a, jconf)
    one_stats = _stats(model.module.state_dict(), jconf)
    assert len(got_stats) == len(one_stats) == len(want_jax) > 0
    before = dict(_stats({k: torch.from_numpy(v) for k, v in sd.items()}, jconf))
    for (path, x), (_, y), (_, z) in zip(got_stats, one_stats, want_jax):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(x, np.asarray(z), rtol=1e-4, atol=1e-6, err_msg=name)
        assert not np.allclose(x, before[path])


def test_v1_syncbn_backward_sums_cotangents_across_ranks(v1):
    """The two ranks' summed gradient (the clip's input) is twice the
    concatenated batch's in one process, every tensor upstream of the
    BatchNorm layers included: that holds only if the statistics'
    all-reduce sums the cotangents over the ranks in its backward (a rank
    that kept its own would miss the other rank's share of d mean and
    d var).  The ranks hand the clip the same bits."""
    a, b = v1[0]["grads"], v1[1]["grads"]
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    model = _v1_model()
    audio, notes = ranks.batch(0)
    logp = model.make_train_loss()(model.frames(audio), model.labels(notes, 16), None)
    (-logp.sum(-1).mean() / 50.0).backward()
    want = {n: 2.0 * p.grad for n, p in model.module.named_parameters()}
    assert set(want) == set(a)
    upstream = 0
    for name, w in want.items():
        g = a[name].numpy()
        if re.fullmatch(r"preLayer\.layers\.\d+\.conv\d\.bias", name):
            scale = max(1.0, float(np.abs(a[name.replace("bias", "weight")].numpy()).max()))
            assert max(np.abs(g).max(), float(w.abs().max())) <= 1e-4 * scale, name
            continue
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * max(np.abs(w).max(), 1e-12), err_msg=name)
        upstream += name.startswith(("framewiseFeatureExtractor", "preLayer")) and np.abs(w).max() > 0
    assert upstream >= 8


def test_dropout_seed_gives_each_rank_its_own_stream():
    """Rank 0's seed is the one-process run's; on the CPU generator (which
    keeps 32 bits of a seed) and the card's alike, the ranks of a step draw
    different masks."""
    assert dropout_seed(1234, 5) == dropout_seed(1234, 5, 0) == 5 * 7919 + 1234
    for step in (0, 1, 10**6):
        seeds = [dropout_seed(2**32 - 3, step, rank) for rank in range(8)]
        assert all(0 <= s < 2**32 for s in seeds)
        draws = [torch.rand(16, generator=torch.Generator().manual_seed(s)) for s in seeds]
        assert all(not torch.equal(draws[a], draws[b]) for a in range(8) for b in range(a))


def test_v1_gru_dropout_follows_the_rank_stream():
    """``nn.GRU`` draws the masks between its layers from torch's global
    generator; the V1 loss seeds it from the step's generator inside and
    restores it after.  So each rank's masks follow its own stream
    (``dropout_seed``), a step's generator gives the same masks twice, and
    the caller's global stream is untouched."""
    conf = {**ranks.V1_CONF, "contextDropoutProb": 0.5}
    model = TransKunAblation(AblationConfig.from_dict(conf), device="cpu", seed=0)
    assert model.module.contextModel.grus.dropout == 0.5
    audio, notes = ranks.batch(0)
    frames, labels = model.frames(audio[:2]), model.labels(notes[:2], 16)
    loss_fn = model.make_train_loss()
    state = torch.get_rng_state()

    def logp(rank):
        with torch.no_grad():
            return loss_fn(frames, labels, torch.Generator().manual_seed(dropout_seed(7, 3, rank)))

    r0, r1, again = logp(0), logp(1), logp(0)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(r0, again)
    assert not torch.allclose(r0, r1)
    model.module.contextModel.grus.dropout = 0.0
    assert torch.equal(logp(0), logp(1))


def test_launch_ranks_stops_the_others_when_one_fails(tmp_path):
    """``parallel.launch_ranks``: when one rank fails, the one still running
    (here asleep, as a rank waiting in a collective would be) is killed at
    once, and the error names each rank's exit code and output.  Rank 0
    creates a marker file once it has printed, and rank 1 fails only after
    it has seen the marker (or after 20 s), so rank 0's line is in its
    output however slowly the host starts the processes."""
    from transkun_tpu_torch.parallel import launch_ranks

    marker = str(tmp_path / "rank0_printed")
    code = ("import os, sys, time; r = int(os.environ['RANK']); print('rank', r, os.environ['WORLD_SIZE'], "
            f"os.environ['LOCAL_RANK'], flush=True); m = {marker!r}\n"
            "if r == 0:\n    open(m, 'w').close(); time.sleep(60)\n"
            "t = time.monotonic()\n"
            "while not os.path.exists(m) and time.monotonic() - t < 20:\n    time.sleep(0.01)\n"
            "sys.exit(3 * r)")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as e:
        launch_ranks(lambda rank: [sys.executable, "-c", code], 2, local_rank=lambda rank: 0, timeout=120)
    assert time.perf_counter() - t0 < 30
    msg = str(e.value)
    assert "ranks exited [-9, 3]" in msg and "rank 0 2 0" in msg and "rank 1 2 0" in msg
    launch_ranks(lambda rank: [sys.executable, "-c", "pass"], 2)
