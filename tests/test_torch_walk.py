"""The stitching chain on the CPU: the port's plain ``walk_backward_device``
and ``walk.walk_group_plain`` (the plain version of the walk kernel
``csrc/decode_walk.cu``) against the JAX package, the group program
``TransKun._fused_group`` against the JAX package's ``_fused_group_traced``
on the same weights and segment audio, and ``transcribe`` on the routes the
chain's overflow flag chooses between against the JAX package's (notes as
in ``test_torch_transcribe.py``: pitch, velocity and flags equal, times
within 1e-6 s).

Tolerance: every integer (events, counts, overflow flags, forced starts,
compact indices, velocities) and the presence bits equal; the refined
onset/offset ``of`` within 1e-4 frames.  Its continuous-Bernoulli mean
subtracts two fp32 terms of size 1/|logit| (``sigmoid(l) / tanh(l / 2) -
1 / l``), so at a logit of 0.009 a few units in the last place of 112 show
as 2.3e-5 between the two frameworks, whose logits differ by ~1e-7; 1e-4
frames is 1.6e-6 s at this hop, the order of the notes' 1e-6 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.ops import semicrf as jsemicrf
from transkun_tpu.utils.torch_convert import convert_state_dict
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun, host_chain
from transkun_tpu_torch.ops import semicrf, walk

from test_torch_transcribe import TINY, _assert_same_notes, _piece
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _tables(rng, t, n):
    """Viterbi tables of random scores (the plain DP, which equals the JAX
    package's exactly), as numpy: the walks' common input."""
    score = (rng.normal(size=(t, t, n)) * 2).astype(np.float32)
    noise = (rng.normal(size=(t - 1, n)) * 0.5).astype(np.float32)
    ptr, diag = semicrf.viterbi_backward_tables(torch.from_numpy(score), torch.from_numpy(noise))
    return ptr.numpy(), diag.numpy()


def _singleton_tables(t, n):
    """Tables whose walk fires a singleton at every position."""
    score = np.full((t, t, n), -5.0, np.float32)
    score[np.arange(t), np.arange(t)] = 5.0
    ptr, diag = semicrf.viterbi_backward_tables(torch.from_numpy(score), torch.ones(t - 1, n))
    return ptr.numpy(), diag.numpy()


@pytest.mark.parametrize("case", ["random", "forced_start", "overflow"])
def test_walk_backward_device_equals_jax(case):
    """The cases of the JAX package's own device-walk tests: random tables,
    forced starts, and a k_max that overflows (every position fires)."""
    rng = np.random.default_rng(1234)
    if case == "random":
        ptr, diag = _tables(rng, 40, 6)
        starts, k_max = np.zeros(6, np.int32), 64
    elif case == "forced_start":
        ptr, diag = _tables(rng, 50, 4)
        starts, k_max = np.array([0, 7, 25, 49], np.int32), 64
    else:
        ptr, diag = _singleton_tables(30, 2)
        starts, k_max = np.zeros(2, np.int32), 8
    want = jsemicrf.walk_backward_device(jnp.asarray(ptr), jnp.asarray(diag), jnp.asarray(starts), k_max)
    got = semicrf.walk_backward_device(
        torch.tensor(ptr), torch.tensor(diag), torch.tensor(starts), k_max)
    for g, w in zip(got, want):
        assert g.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "overflow":
        assert got[3].all() and int(got[2].max()) == k_max
    else:
        assert not got[3].any()
    # and the events are the host walk's, in its order
    host = semicrf.backtrack_backward(ptr, diag, starts.tolist())
    for b, events in enumerate(host):
        n = int(got[2][b])
        assert list(zip(got[0][b, :n].tolist(), got[1][b, :n].tolist())) == events[:n]


@pytest.fixture(scope="module")
def models():
    """The port's model with seeded weights and a confident scorer (as in
    ``test_torch_transcribe.py``), the JAX package's model with the same
    weights through its ``convert_state_dict``, and a piece's padded audio
    with its segment plan."""
    conf_j = JaxModelConfig.from_dict(TINY)
    jax_model = JaxTransKun(conf_j)
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu", seed=2)
    with torch.no_grad():
        m = model.module.scorer.map[0]
        e = m.weight.shape[0] // 2
        m.weight *= 10.0
        m.bias[0] += 6.0
        m.bias[e] -= 6.0
        m.bias[-1] = -8.0
    sd = dict(model.module.state_dict())
    # the JAX package ties the upsample bias over its 8 steps: the port's
    # untied one is zero from the seed, so its first step is the tied one
    bias = sd["backbone.upConv1dSkip.bias"]
    out = bias.numel() // 8
    assert torch.equal(bias, bias[:out].repeat(8))
    sd["backbone.upConv1dSkip.bias"] = bias[:out]
    params = convert_state_dict(sd, conf_j)
    fs, hop = TINY["fs"], TINY["hopSize"]
    pad = fs  # segment 2 s, hop 1 s
    segment_size = 2 * fs
    step = -(-fs // hop) * hop
    audio = np.pad(_piece(dur=5.0, seed=7).T, ((0, 0), (pad, pad + segment_size)))
    plan = {"segment_size": segment_size, "step": step, "step_frames": step // hop,
            "last_frame_idx": round(segment_size / hop), "start": fs // hop - 1}
    return jax_model, params, model, audio, plan


@pytest.mark.parametrize("case", ["default", "onset_bound", "overflow"])
def test_group_chain_equals_jax(models, case):
    """``walk_group_plain`` and ``_fused_group`` against
    ``_fused_group_traced`` on three segments of the piece: the default
    capacities from the piece's first start; ``onset_bound`` (the second
    half discarded) from random forced starts; and a k_max and a budget
    small enough that both overflow."""
    jax_model, params, model, audio, plan = models
    starts = [plan["step"] * (i + 1) for i in range(3)]
    k_max, k_budget, onset_bound = 128, 2048 * 3, -1
    start_pos = np.full(90, plan["start"], np.int32)
    if case == "onset_bound":
        onset_bound = plan["step"] // TINY["hopSize"]
        start_pos = np.random.default_rng(5).integers(0, 120, size=90).astype(np.int32)
    elif case == "overflow":
        k_max, k_budget = 1, 16
    geometry = (plan["last_frame_idx"], plan["step_frames"], k_max, k_budget)

    seg_audio = np.stack([audio[:, s : s + plan["segment_size"]] for s in starts])
    fn = jax.jit(jax_model._fused_group_traced, static_argnums=(3, 4, 5, 6, 7, 8))
    want = [np.asarray(a) for a in fn(params, seg_audio, jnp.asarray(start_pos), "hamming",
                                      onset_bound, *geometry)]
    audio_t, start_t = torch.from_numpy(audio), torch.from_numpy(start_pos)
    with torch.no_grad():
        got = [a.numpy() for a in model._fused_group(
            audio_t, starts, start_t, "hamming", onset_bound, plan["segment_size"],
            plan["last_frame_idx"], plan["step_frames"], k_max, k_budget)]
        tables = model._group_tables(audio_t, starts, plan["segment_size"], plan["last_frame_idx"])
        chain = walk.walk_group_plain(*tables[:3], start_t, k_max, plan["last_frame_idx"],
                                      plan["step_frames"], onset_bound)

    count = int(want[6])
    assert int(got[6]) == count > 0
    np.testing.assert_array_equal(got[7], want[7])  # the next group's forced starts
    np.testing.assert_array_equal(chain[4].numpy(), want[7])
    assert bool(got[8]) == bool(want[8]) == (case == "overflow")
    assert bool(chain[3].any()) == (count > k_budget) == (case == "overflow")
    assert chain[2].dtype == torch.int32 and int(chain[2].max()) <= k_max
    kept = min(count, k_budget)
    for i in (0, 1, 2, 3, 5):  # src, cb, ce, velocity, presence
        np.testing.assert_array_equal(got[i][:kept], want[i][:kept].astype(got[i].dtype))
    np.testing.assert_allclose(got[4][:kept], want[4][:kept], rtol=0, atol=1e-4)
    # the compact events are the walk's valid events, in (segment, track, k) order
    flat = np.flatnonzero(np.arange(k_max) < chain[2].numpy()[..., None])
    if onset_bound >= 0:
        flat = flat[chain[0].numpy().reshape(-1)[flat] < onset_bound]
    np.testing.assert_array_equal(got[0][:kept], flat[:kept])
    np.testing.assert_array_equal(got[1][:kept], chain[0].numpy().reshape(-1)[flat[:kept]])


def test_walk_group_plain_chains_the_host_walk(models):
    """The chain of ``walk_group_plain`` over a group is the host route's
    (``host_chain``, which ``_process_group`` runs): per segment the events
    of ``backtrack_backward`` from the start the previous segment handed on,
    zeros past them, and the same next starts."""
    _, _, model, audio, plan = models
    starts = [plan["step"] * i for i in range(3)]
    with torch.no_grad():
        ptr, diag, bpres, _ = model._group_tables(
            torch.from_numpy(audio), starts, plan["segment_size"], plan["last_frame_idx"])
    start = [plan["start"]] * 90
    begins, ends, count, overflow, next_start = walk.walk_group_plain(
        ptr, diag, bpres, torch.tensor(start, dtype=torch.int32), 128, plan["last_frame_idx"],
        plan["step_frames"])
    paths, want_start = host_chain(ptr.numpy(), diag.numpy(), bpres.numpy(), start,
                                   plan["last_frame_idx"], plan["step_frames"])
    assert not overflow.any() and int(count.sum()) > 0
    assert next_start.tolist() == want_start
    for gi, path in enumerate(paths):
        for j, events in enumerate(path):
            n = int(count[gi, j])
            assert list(zip(begins[gi, j, :n].tolist(), ends[gi, j, :n].tolist())) == events
            assert not begins[gi, j, n:].any() and not ends[gi, j, n:].any()


def test_walk_group_routes_by_device():
    """On a CPU tensor ``walk_group`` is the plain version and launches
    nothing; a tensor on another device has no route."""
    ptr, diag = _tables(np.random.default_rng(0), 20, 90)
    ptr_t = torch.from_numpy(ptr)[None].contiguous()
    diag_t = torch.from_numpy(diag)[None].contiguous()
    bpres = torch.zeros(1, 90, 20, 2, dtype=torch.bool)
    start = torch.zeros(90, dtype=torch.int32)
    before = walk.launches
    got = walk.walk_group(ptr_t, diag_t, bpres, start, 16, 18, 9)
    want = walk.walk_group_plain(ptr_t, diag_t, bpres, start, 16, 18, 9)
    assert walk.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        walk.walk_group(ptr_t.to("meta"), diag_t.to("meta"), bpres.to("meta"), start.to("meta"),
                        16, 18, 9)


@pytest.fixture(scope="module")
def routes(models):
    """The JAX package's ``transcribe`` (its default, fused route) and the
    port's on a piece of 9 segments in groups of 3, the weights of
    ``models``; the port also at a budget that the first group fits and a
    later one does not, and at a budget of 1 (the host-walk route from the
    first group).  The JAX package's notes and group counts do not depend on
    the budget (its own ``test_fused_decode_midpiece_overflow_fallback``), so
    its default route is the reference of all three.  Both packages' last
    groups are full here: the JAX package also walks the zero segments that
    pad a last group, and counts their events, where the port runs only the
    piece's segments."""
    jax_model, params, model, _, _ = models
    audio = _piece(dur=7.0, seed=4)
    want = jax_model.transcribe(params, audio, segment_batch=3)
    counts = jax_model.last_transcribe_group_counts
    assert jax_model.last_transcribe_fallback_from is None
    out = {}
    for route, budget in (("default", None), ("midpiece", max(counts[0], max(counts[1:]) - 1)),
                          ("host", 1)):
        model.decode_k_budget = budget
        notes = model.transcribe(audio, segment_batch=3)
        out[route] = (budget, notes, model.last_transcribe_group_counts,
                      model.last_transcribe_fallback_from)
    model.decode_k_budget = None
    return want, counts, out


@pytest.mark.parametrize("route", ["default", "midpiece", "host"])
def test_routes_match_jax(routes, route):
    """The port's default route, the mid-piece fallback and the host-walk
    route each give the JAX package's notes and group counts, and fall back
    from the first group whose count passes the budget; and the same notes
    as each other."""
    want, want_counts, out = routes
    budget, got, counts, got_from = out[route]
    assert len(want) > 50
    assert counts == want_counts and len(counts) == 3 and min(counts) > 0
    first_over = next((g for g, c in enumerate(counts) if c > (budget or 2048 * 3)), None)
    assert got_from == first_over == {"default": None, "midpiece": 1, "host": 0}[route]
    _assert_same_notes(got, want)
    _assert_same_notes(got, out["default"][1])


@pytest.mark.parametrize("p", [1, 7, 8, 9, 89, 90, 257])
def test_launch_plan_covers_every_track_once(p):
    """The CTAs' tiles of tracks ``[i * tile, min(P, (i + 1) * tile))`` cover
    every track exactly once, with no CTA left without one; a tile is a
    power of two that one walker warp holds."""
    for n, t, k_max in ((4, 691, 128), (1, 61, 2), (4, 691, 2048), (4, 691, 16384)):
        plan = walk.launch_plan(n, t, p, k_max)
        assert plan.tile & (plan.tile - 1) == 0 and 1 <= plan.tile <= 32
        tracks = [b for i in range(plan.blocks) for b in range(i * plan.tile, min(p, (i + 1) * plan.tile))]
        assert tracks == list(range(p))
        assert (plan.blocks - 1) * plan.tile < p


@pytest.mark.parametrize("k_max", [1, 4, 128, 2048])
@pytest.mark.parametrize("t", [2, 61, 123, 691])
def test_launch_plan_shared_memory_fits(t, k_max):
    """Dynamic shared memory at or under the 232,448 bytes a Hopper CTA may
    take, and the plan's own count of it, for groups of 1 to 16 segments
    up to the 16 s segment's t = 691; at these sizes every segment's
    columns are staged or, past the room for all of them, a ring of at
    least two."""
    for n in (1, 2, 4, 16):
        plan = walk.launch_plan(n, t, 90, k_max)
        assert plan.smem <= 232448
        assert plan.smem == walk.smem_bytes(t, plan.tile, plan.slots, plan.buffered, k_max, 2)
        assert plan.buffered and (plan.slots == n or 2 <= plan.slots < n)


def test_launch_plan_routes():
    """The event buffer where it fits; events stored to global memory where
    one tile's buffer does not fit; the tables read from global memory only
    where one segment of a tile's columns does not fit in shared memory."""
    flagship = walk.launch_plan(4, 691, 90, 128)
    assert (flagship.tile, flagship.slots, flagship.buffered) == (walk.TILE, 4, True)
    assert flagship.blocks == -(-90 // walk.TILE)
    # a tile's buffers of 16384 events take 256 KB: the global route
    assert walk.smem_bytes(691, walk.TILE, 1, True, 16384) > 232448
    wide = walk.launch_plan(4, 691, 90, 16384)
    assert not wide.buffered and wide.slots == 4 and wide.tile == walk.TILE
    # a segment of 30000 positions: a tile's columns take 300 KB
    assert walk.smem_bytes(30000, walk.TILE, 1, False, 128) > 232448
    long = walk.launch_plan(1, 30000, 90, 128)
    assert long.slots == 0 and long.buffered
    with pytest.raises(ValueError):
        walk.launch_plan(4, 1, 90, 128)
