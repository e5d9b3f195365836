"""The port's Viterbi tables against the JAX package: the plain PyTorch DP
against the Pallas kernel (interpret mode) and the scan, bit for bit, plus
the host pointer walks and the left-to-right DP (``decode(forward=True)``).  The CUDA kernel against the plain version is in
``test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.ops import semicrf as jsemicrf
from transkun_tpu.ops import semicrf_pallas as sp
from transkun_tpu_torch.ops import semicrf, viterbi

NEG = -1e30


@pytest.fixture
def interpret_mode():
    sp.INTERPRET = True
    yield
    sp.INTERPRET = False


def _decode_inputs(rng, t, nb, ties):
    """NEG-padded decode-layout inputs ([begin, end, lane]) as numpy.  With
    ``ties`` the scores are small integers, so equal candidates abound."""
    tp, nbp = -(-t // 8) * 8, -(-nb // 128) * 128
    if ties:
        s = rng.integers(-3, 3, size=(t, t, nb)).astype(np.float32)
        noise = rng.integers(-1, 2, size=(t - 1, nb)).astype(np.float32)
    else:
        s = rng.normal(size=(t, t, nb)).astype(np.float32)
        noise = rng.normal(size=(t - 1, nb)).astype(np.float32) * 0.1
    s_t = np.full((tp, tp, nbp), NEG, np.float32)
    s_t[:t, :t, :nb] = s
    noise_p = np.zeros((tp, nbp), np.float32)
    noise_p[: t - 1, :nb] = noise
    diag = np.zeros((tp, nbp), np.float32)
    diag[:t, :nb] = np.einsum("iin->in", s)
    return s_t, noise_p, diag * (diag > 0)


@pytest.mark.parametrize("t,nb,ties", [(13, 3, False), (37, 130, False), (24, 90, True)])
def test_plain_equals_pallas_kernel(rng, interpret_mode, t, nb, ties):
    s_t, noise, diag_gate = _decode_inputs(rng, t, nb, ties)
    want = np.asarray(
        sp.viterbi_backward_tables_padded(
            jnp.asarray(s_t), jnp.asarray(noise), jnp.asarray(diag_gate)
        )
    )
    before = viterbi.launches
    got = viterbi.viterbi_backward_tables_padded(
        torch.from_numpy(s_t), torch.from_numpy(noise), torch.from_numpy(diag_gate)
    )
    assert viterbi.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)  # exact
    # the padded positions and lanes reduce to skip chains
    assert (got.numpy()[t - 1 :] == -1).all() and (got.numpy()[:, nb:] == -1).all()


@pytest.mark.parametrize("t,nb,ties", [(2, 1, False), (30, 5, False), (30, 5, True)])
def test_unpadded_tables_equal_scan(rng, t, nb, ties):
    if ties:
        s = rng.integers(-2, 3, size=(t, t, nb)).astype(np.float32)
        n = rng.integers(-1, 2, size=(t - 1, nb)).astype(np.float32)
    else:
        s = rng.normal(size=(t, t, nb)).astype(np.float32)
        n = rng.normal(size=(t - 1, nb)).astype(np.float32)
    ptr_j, diag_j = jsemicrf.viterbi_backward_tables(jnp.asarray(s), jnp.asarray(n))
    ptr, diag = semicrf.viterbi_backward_tables(torch.from_numpy(s), torch.from_numpy(n))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(ptr_j))  # exact
    np.testing.assert_array_equal(diag.numpy(), np.asarray(diag_j))


def test_backtrack_backward_equals_jax(rng):
    t, nb = 40, 6
    s = rng.normal(size=(t, t, nb)).astype(np.float32)
    s[np.arange(t), np.arange(t)] -= 1.0  # fewer singletons
    n = np.zeros((t - 1, nb), np.float32)
    ptr, diag = semicrf.viterbi_backward_tables(torch.from_numpy(s), torch.from_numpy(n))
    ptr, diag = ptr.numpy(), diag.numpy()
    for forced in (None, [0, 3, 7, 39, 12, 1]):
        want = jsemicrf.backtrack_backward(ptr, diag, forced)
        got = semicrf.backtrack_backward(ptr, diag, forced)
        assert got == want
    assert any(len(p) > 1 for p in got)


def _scores(rng, t, nb, ties):
    if ties:  # small integers: equal candidates abound
        s = rng.integers(-2, 3, size=(t, t, nb)).astype(np.float32)
        n = rng.integers(-1, 2, size=(t - 1, nb)).astype(np.float32)
    else:
        s = rng.normal(size=(t, t, nb)).astype(np.float32)
        n = rng.normal(size=(t - 1, nb)).astype(np.float32)
    return s, n


@pytest.mark.parametrize("t,nb,ties", [(2, 1, False), (30, 5, False), (30, 5, True), (17, 3, True)])
def test_forward_tables_equal_scan(rng, t, nb, ties):
    s, n = _scores(rng, t, nb, ties)
    ptr_j, diag_j = jsemicrf.viterbi_forward_tables(jnp.asarray(s), jnp.asarray(n))
    ptr, diag = semicrf.viterbi_forward_tables(torch.from_numpy(s), torch.from_numpy(n))
    assert ptr.dtype == torch.int32 and tuple(ptr.shape) == (t - 1, nb)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(ptr_j))  # exact
    np.testing.assert_array_equal(diag.numpy(), np.asarray(diag_j))


def test_backtrack_forward_equals_jax(rng):
    t, nb = 40, 6
    s, n = _scores(rng, t, nb, False)
    s[np.arange(t), np.arange(t)] -= 1.0  # fewer singletons
    ptr, diag = semicrf.viterbi_forward_tables(torch.from_numpy(s), torch.from_numpy(n * 0))
    ptr, diag = ptr.numpy(), diag.numpy()
    for forced in (None, [39, 3, 7, 0, 12, 1]):
        want = jsemicrf.backtrack_forward(ptr, diag, forced)
        got = semicrf.backtrack_forward(ptr, diag, forced)
        assert got == want
    assert any(len(p) > 1 for p in got)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("forward", [False, True])
def test_decode_equals_jax(rng, forward, ties):
    t, nb = 33, 4
    s, n = _scores(rng, t, nb, ties)
    crf_j = jsemicrf.NeuralSemiCRFInterval(jnp.asarray(s), jnp.asarray(n))
    crf = semicrf.NeuralSemiCRFInterval(torch.from_numpy(s), torch.from_numpy(n))
    for forced in (None, [5, 0, 32, 17]):
        assert crf.decode(forced, forward=forward) == crf_j.decode(forced, forward=forward)
    # without ties the two directions find the same best path
    if not ties:
        assert crf.decode(forward=True) == crf.decode()


# the path's shapes (decode [696,696,128], the stats pass [696,696,384]),
# the ragged one, one lane group, and more lane groups than SMs
PLAN_SHAPES = [(696, 128), (696, 384), (128, 256), (128, None), (64, 8192)]


def check_plan(plan, tp, nbp, n_sm, smem_limit):
    """What a launch plan of the blocked cluster kernels must give: each lane
    in one lane group, every earlier position of every block reduced by
    exactly one thread slot of the cluster, shared memory within the limit, a
    cluster size the card allows, and all clusters on the card at once
    whenever the groups allow."""
    from transkun_tpu_torch.ops import _cluster

    lanes = [lane for cta in range(0, plan.ctas, plan.cluster)
             for lane in _cluster.lanes_of_cta(plan, cta)]
    assert sorted(lanes) == list(range(nbp))
    for k0 in range(0, tp, _cluster.BLOCK):
        others = [m for rank in range(plan.cluster) for slot in range(_cluster.SLOTS)
                  for m in _cluster.others_of_thread(plan, rank, slot, k0)]
        assert sorted(others) == list(range(k0))
    assert plan.smem <= smem_limit
    assert plan.cluster in _cluster.CLUSTER_SIZES and plan.portable == (plan.cluster <= 8)
    fits = _cluster.model_max_clusters(n_sm)
    assert plan.groups <= fits[plan.cluster] or plan.cluster == 1
    blocks = -(-tp // _cluster.BLOCK)
    assert all(plan.groups > fits[c] for c in _cluster.CLUSTER_SIZES
               if plan.cluster < c <= blocks)  # no larger cluster fits
    assert plan.threads == 256


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp,nbp", PLAN_SHAPES)
def test_launch_plan_covers_every_lane_and_end(tp, nbp, dtype, n_sm):
    from transkun_tpu_torch.ops import _build, _cluster

    lanes = _cluster.lanes_per_cta(dtype)
    nbp = nbp or lanes
    plan = viterbi.launch_plan(tp, nbp, dtype, n_sm)
    assert plan.lanes == lanes == (8 if dtype == torch.float32 else 16)
    assert plan.groups == nbp // lanes
    check_plan(plan, tp, nbp, n_sm, _build.SMEM_LIMIT)
    if (tp, nbp, n_sm) == (696, 128, 132):  # the decode shape fills the card
        assert plan.ctas == 128 and plan.cluster == (8 if dtype == torch.float32 else 16)


def test_plan_takes_the_cards_own_cluster_counts():
    """The wrappers plan with what the card reports (asked once) in place of
    the model: a card that holds fewer clusters gets a smaller cluster."""
    import ctypes

    from transkun_tpu_torch.ops import _cluster

    asked = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int))

    def report(tp, cluster, bf16, device, n):  # 15 clusters of 8, 7 of 16, ... as an H100
        asked.append(cluster)
        n[0] = {1: 132, 2: 66, 8: 15, 16: 7}.get(cluster, 120 // cluster)
        return 0

    query = proto(report)
    counts = _cluster.card_max_clusters(query, 696, torch.float32, 0)
    assert _cluster.card_max_clusters(query, 696, torch.float32, 0) is counts  # asked once
    assert asked == list(_cluster.CLUSTER_SIZES) and counts[8] == 15
    plan = viterbi.launch_plan(696, 128, torch.float32, 132, max_clusters=counts)
    assert plan.cluster == 7 and plan.ctas == 112  # 16 clusters of 8 would not fit at once
