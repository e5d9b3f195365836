"""The clip and AdaBelief on one flat buffer of every leaf, on the tiny V2
tree: bit for bit against the per-leaf update they replaced (kept here as
the reference), the clip ring's device-side quantile and push against
``np.quantile``, the moments' state by name, and the step's clip and
optimizer under ``torch.profiler``: no value read on the host, no tensor
made from host data, and the same number of operations for models with
different numbers of leaves.  On the card (``gpu``): the flat update bit
for bit against the per-leaf one there too, and the clip and optimizer of
a step under ``torch.cuda.set_sync_debug_mode("error")``.

Imports no JAX, so the card's test runs on a machine with a card and no
JAX:

    python -m pytest tests/test_torch_optim_flat.py --noconftest -q -m gpu
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from transkun_tpu_torch.data.note import Note
from transkun_tpu_torch.models.config import ModelConfig
from transkun_tpu_torch.models.transkun import TransKun
from transkun_tpu_torch.train.optim import AdaBelief, QuantileClip, rectification_gate
from transkun_tpu_torch.train.step import TrainState, make_train_step
from transkun_tpu_torch.utils import profiling

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FS = 4000
TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0,
    "segmentHopSizeInSecond": 1.0,
}
OPT = dict(max_lr=1e-2, weight_decay=0.5, n_iter=20, warmup_cutoff=2)
# operations that only make a view: their count follows the leaves
VIEW_OPS = {"aten::split", "aten::split_with_sizes", "aten::slice", "aten::narrow", "aten::view",
            "aten::view_as", "aten::reshape", "aten::_reshape_alias", "aten::as_strided", "aten::detach",
            "aten::unbind", "aten::select", "aten::alias"}
HOST_READS = {"aten::item", "aten::_local_scalar_dense", "aten::lift_fresh"}


def _model(n_layers=1, device="cpu", seed=0):
    return TransKun(ModelConfig.from_dict({**TINY, "nLayers": n_layers}), device=device, seed=seed)


def _batch(n=2, seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=(n, FS, 1)) * 0.1).astype(np.float32)
    notes = [[Note(0.1, 0.4, 60, 80), Note(0.45, 0.8, 60, 70), Note(0.2, 0.9, 64, 90)] for _ in range(n)]
    return audio, notes


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


class PerLeafAdaBelief:
    """The per-leaf update the flat one replaced, on its own copies of the
    parameters and moments: the same arithmetic leaf by leaf."""

    def __init__(self, opt: AdaBelief):
        self.named = [(n, p.detach().clone()) for n, p in opt.named]
        self.mask, self.schedule = opt.mask, opt.schedule
        self.weight_decay, self.b1, self.b2, self.eps = opt.weight_decay, opt.b1, opt.b2, opt.eps
        self.count = opt.count.clone()
        self.mu = {n: v.clone() for n, v in opt.mu.items()}
        self.nu = {n: v.clone() for n, v in opt.nu.items()}

    @torch.no_grad()
    def step(self, grads, finite):
        b1, b2 = self.b1, self.b2
        count_inc = self.count + 1
        lr = self.schedule(self.count) * rectification_gate(self.count, b2)
        bc1 = 1 - b1 ** count_inc
        bc2 = 1 - b2 ** count_inc
        for (name, p), g in zip(self.named, grads):
            mu = (1 - b1) * g + b1 * self.mu[name]
            err = g - mu
            nu = (1 - b2) * (err * err) + b2 * self.nu[name]
            nu = nu + 1e-16
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.mask[name]:
                u = u + self.weight_decay * p
            p.copy_(torch.where(finite, p + (-lr) * u, p))
            self.mu[name] = torch.where(finite, mu, self.mu[name])
            self.nu[name] = torch.where(finite, nu, self.nu[name])
        self.count = torch.where(finite, count_inc, self.count)


def _assert_same_bits(opt: AdaBelief, ref: PerLeafAdaBelief):
    assert int(opt.count) == int(ref.count) and opt.count.dtype == ref.count.dtype == torch.int32
    for (name, p), (_, want) in zip(opt.named, ref.named):
        assert torch.equal(_bits(p), _bits(want)), ("param", name)
        assert torch.equal(_bits(opt.mu[name]), _bits(ref.mu[name])), ("mu", name)
        assert torch.equal(_bits(opt.nu[name]), _bits(ref.nu[name])), ("nu", name)


@pytest.mark.parametrize("start_count", [0, 1000])
def test_flat_update_bit_for_bit_against_per_leaf(start_count):
    """Five steps on the same gradients, as a list and as a flat buffer in
    turns, then one step with a NaN gradient (the guard's ``finite`` false)
    that must change no bit, then one more step."""
    model = _model()
    opt = AdaBelief(model.module.named_parameters(), **OPT)
    assert set(opt.mask.values()) == {True, False}  # decayed and undecayed leaves
    opt.count.fill_(start_count)
    ref = PerLeafAdaBelief(opt)
    start = [p.detach().clone() for _, p in opt.named]
    rng = np.random.default_rng(3)
    shapes = [p.shape for _, p in opt.named]
    for k in range(7):
        grads = [torch.from_numpy((rng.normal(size=s) * rng.uniform(0.5, 3.0)).astype(np.float32))
                 for s in shapes]
        if k == 5:
            grads[2].view(-1)[0] = float("nan")
        finite = torch.isfinite(torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads])))
        assert bool(finite) == (k != 5)
        opt.step(grads if k % 2 else torch.cat([g.reshape(-1) for g in grads]), finite)
        ref.step(grads, finite)
        _assert_same_bits(opt, ref)
    assert int(opt.count) == start_count + 6
    # past the rectification gate (from count 1000, or at count 0's fifth step) the parameters move
    assert any(not torch.equal(p, p0) for (_, p), p0 in zip(opt.named, start))


def test_float32_required():
    model = _model()
    model.module.to(torch.float64)
    with pytest.raises(TypeError):
        AdaBelief(model.module.named_parameters(), **OPT)
    clip = QuantileClip("cpu")
    with pytest.raises(TypeError):
        clip([torch.ones(3, dtype=torch.float64)], 0.8)


@pytest.mark.parametrize("q", [0.0, 0.3, 0.8, 1.0])
def test_quantile_and_push_against_numpy(q):
    """A ring of 7 slots seeded with 40: the clip value after each push
    against ``np.quantile`` of the filled slots (below, at and past the
    ring's length, so the writes wrap around), the ring against a host copy,
    and a push with ``finite`` false that writes nothing."""
    maxlen = 7
    clip = QuantileClip("cpu", init_value=40.0, maxlen=maxlen)
    ring, count = np.zeros(maxlen, np.float32), 1
    ring[0] = 40.0
    rng = np.random.default_rng(int(q * 10))
    for k in range(17):
        want = np.quantile(ring[:min(count, maxlen)].astype(np.float64), q)
        np.testing.assert_allclose(float(clip.quantile(q)), want, rtol=1e-6)
        norm = np.float32(rng.uniform(0.0, 80.0))
        clip.push(torch.tensor(norm), torch.tensor(k != 9))
        if k != 9:
            ring[count % maxlen] = norm
            count += 1
        np.testing.assert_array_equal(clip.buffer.numpy(), ring)
        assert clip.count.dtype == torch.int32 and int(clip.count) == count
    assert count > 2 * maxlen


def test_clip_takes_a_list_or_a_flat_buffer():
    """The same clipped entries, norm and clip value from the leaves and from
    their flat buffer; the norm against numpy in float64."""
    rng = np.random.default_rng(1)
    leaves = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 30) for s in ((3, 4), (5,), (2, 2, 2))]
    clip = QuantileClip("cpu")
    a = clip(leaves, 0.8)
    b = clip(torch.cat([g.reshape(-1) for g in leaves]), 0.8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    flat = np.concatenate([g.numpy().reshape(-1) for g in leaves]).astype(np.float64)
    np.testing.assert_allclose(float(a[1]), np.sqrt((flat ** 2).sum()), rtol=1e-6)
    assert float(a[1]) > 40.0
    np.testing.assert_allclose(a[0].numpy(), flat * 40.0 / (np.sqrt((flat ** 2).sum()) + 1e-6), rtol=1e-5)


def test_state_dict_round_trips_by_name():
    """The moments load by name (the dicts handed in reversed order) into
    another optimizer's views, which then step in the same bits as the
    first; ``mu`` and ``nu`` stay views of the flat buffers."""
    model = _model()
    opt = AdaBelief(model.module.named_parameters(), **OPT)
    opt.count.fill_(1000)
    rng = np.random.default_rng(4)
    shapes = [p.shape for _, p in opt.named]

    def grads():
        return [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]

    yes = torch.tensor(True)
    for _ in range(3):
        opt.step(grads(), yes)
    sd = opt.state_dict()
    saved = {"count": sd["count"].clone(),
             "mu": {k: v.clone() for k, v in reversed(list(sd["mu"].items()))},
             "nu": {k: v.clone() for k, v in reversed(list(sd["nu"].items()))}}
    other_model = _model(seed=7)
    other_model.module.load_state_dict(model.module.state_dict())
    other = AdaBelief(other_model.module.named_parameters(), **OPT)
    other.load_state_dict(saved)
    for name in opt.mu:
        assert torch.equal(other.mu[name], opt.mu[name]) and torch.equal(other.nu[name], opt.nu[name])
        assert other.mu[name].untyped_storage().data_ptr() == other._mu.untyped_storage().data_ptr()
    assert int(other.count) == 1003
    g = grads()
    opt.step(g, yes)
    other.step(g, yes)
    for (name, p), (_, q) in zip(opt.named, other.named):
        assert torch.equal(_bits(p), _bits(q)) and torch.equal(opt.mu[name], other.mu[name]), name


def _profiled_step(n_layers):
    """One training step of a tiny model under ``torch.profiler`` (CPU),
    after a warm-up step: the direct children of the clip and optimizer
    spans, and every operation beneath them."""
    model = _model(n_layers)
    state = TrainState(model, AdaBelief(model.module.named_parameters(), **OPT))
    step_fn = make_train_step(model)
    audio, notes = _batch()
    frames, labels = model.frames(audio), model.labels(notes, 8)
    step_fn(state, frames, labels, torch.Generator().manual_seed(0))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m = step_fn(state, frames, labels, torch.Generator().manual_seed(1))
    assert bool(m["finite"])
    spans = {"transkun.clip": [], "transkun.optimizer": []}
    beneath = []

    def walk(e):
        for c in e.cpu_children:
            beneath.append(c.name)
            walk(c)

    for e in prof.events():
        if e.name in spans:
            assert not spans[e.name], e.name  # one of each a step
            spans[e.name] = [c.name for c in e.cpu_children]
            walk(e)
    assert all(spans.values()), spans
    return len(state.optimizer.named), spans, beneath


def test_clip_and_optimizer_read_nothing_on_the_host_and_launch_a_fixed_count():
    """No ``item`` (a device value read by the host) and no tensor made
    from host data inside the clip and optimizer spans; the operations that
    are their direct children, views left out, are the same for one and two
    encoder layers (different numbers of leaves)."""
    counts = {}
    for n_layers in (1, 2):
        n_leaves, spans, beneath = _profiled_step(n_layers)
        assert not HOST_READS & set(beneath), sorted(HOST_READS & set(beneath))
        ops = {name: [c for c in children if c not in VIEW_OPS] for name, children in spans.items()}
        counts[n_layers] = (n_leaves, {name: len(v) for name, v in ops.items()}, ops)
    assert counts[2][0] > counts[1][0]  # more leaves
    assert counts[1][1] == counts[2][1], (counts[1][2], counts[2][2])
    assert "aten::_foreach_copy_" in counts[1][2]["transkun.optimizer"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("start_count", [0, 1000])
def test_flat_update_bit_for_bit_on_the_card(cuda, start_count):
    """As ``test_flat_update_bit_for_bit_against_per_leaf``, with the
    card's kernels: four steps, the third with a NaN gradient."""
    model = _model(device=cuda)
    opt = AdaBelief(model.module.named_parameters(), **OPT)
    opt.count.fill_(start_count)
    ref = PerLeafAdaBelief(opt)
    gen = torch.Generator(device=cuda).manual_seed(start_count)
    for k in range(4):
        grads = [torch.randn(p.shape, generator=gen, device=cuda) * (k + 1) for _, p in opt.named]
        if k == 2:
            grads[-1].view(-1)[0] = float("nan")
        finite = torch.isfinite(torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads])))
        opt.step(grads, finite)
        ref.step(grads, finite)
        _assert_same_bits(opt, ref)
    assert int(opt.count) == start_count + 3


@pytest.mark.gpu
def test_clip_and_optimizer_never_synchronize_on_the_card(cuda, monkeypatch):
    """After two warm-up steps, one step's clip and optimizer spans run
    under ``torch.cuda.set_sync_debug_mode("error")``: any call that waits
    for the card or copies from pageable host memory raises."""
    model = _model(device=cuda)
    state = TrainState(model, AdaBelief(model.module.named_parameters(), **OPT))
    state.optimizer.count.fill_(1000)
    step_fn = make_train_step(model)
    audio, notes = _batch()
    frames, labels = model.frames(audio), model.labels(notes, 8)
    for k in range(2):
        step_fn(state, frames, labels, torch.Generator(device=cuda).manual_seed(k))
    torch.cuda.synchronize()
    span, watched = profiling.span, []

    @contextlib.contextmanager
    def strict(name, key=None):
        with span(name, key):
            if name not in ("transkun.clip", "transkun.optimizer"):
                yield
                return
            watched.append(name)
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(profiling, "span", strict)
    before = [p.detach().clone() for _, p in state.optimizer.named]
    m = step_fn(state, frames, labels, torch.Generator(device=cuda).manual_seed(2))
    torch.cuda.synchronize()
    assert watched == ["transkun.clip", "transkun.optimizer"]
    assert bool(m["finite"]) and int(state.optimizer.count) == 1003
    assert any(not torch.equal(b, p) for b, (_, p) in zip(before, state.optimizer.named))
