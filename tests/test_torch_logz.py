"""The port's semi-CRF partition function against the JAX package, on the CPU.

* The plain alpha and beta tables (the CUDA kernels' plain versions, which
  the CPU runs) against the Pallas kernels in interpret mode and the JAX
  scan, at a ragged t with padded lanes: atol 2e-4, as the JAX package's
  own kernel tests.
* logZ, its score and noise cotangents, and ``log_z_padded``'s contract
  (logZ 0 and a zero cotangent on padded lanes, a masked noise cotangent)
  against ``jax.grad``: atol 1e-3 (sums in another order over t <= 40).
* Path scores and route 1b of the Viterbi tables: path scores to 1e-5, the
  pointer tables exactly.
* The unpadded ``log_z`` of the V1 route, with a nonzero noise, against the
  JAX scan and ``jax.grad`` (1e-5), and the ``*_best`` dispatch on CPU
  tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.ops import semicrf as jsemicrf
from transkun_tpu.ops import semicrf_pallas as sp
from transkun_tpu_torch.ops import logz, semicrf

NEG = -1e30


@pytest.fixture(autouse=True)
def interpret_mode():
    sp.INTERPRET = jax.default_backend() != "tpu"
    yield
    sp.INTERPRET = False


def _scores(rng, t, nb):
    s = rng.normal(size=(t, t, nb)).astype(np.float32)
    n = (rng.normal(size=(t - 1, nb)) * 0.5).astype(np.float32)
    return s, n


def _pad(s, n, tp, nbp):
    """NEG-pad the score and zero-pad the noise as the fused scorer does:
    noise_pad row i = noise[i], rows >= t-1 zero."""
    t, _, nb = s.shape
    s_pad = np.full((tp, tp, nbp), NEG, np.float32)
    s_pad[:t, :t, :nb] = s
    noise_pad = np.zeros((tp, nbp), np.float32)
    noise_pad[: t - 1, :nb] = n
    return s_pad, noise_pad


def _table_inputs(s_pad, noise_pad):
    spdiag = np.logaddexp(np.einsum("iin->in", s_pad), 0.0).astype(np.float32)
    noise_shift = np.concatenate([np.zeros_like(noise_pad[:1]), noise_pad[:-1]])
    return spdiag, noise_shift


@pytest.mark.parametrize("t,nb", [(13, 3), (37, 5)])
def test_plain_tables_match_pallas_interpret_and_scan(t, nb):
    rng = np.random.default_rng(t)
    s, n = _scores(rng, t, nb)
    tp, nbp = -(-t // 8) * 8, 128
    s_pad, noise_pad = _pad(s, n, tp, nbp)
    spdiag, noise_shift = _table_inputs(s_pad, noise_pad)

    v = logz.alpha_table_padded(*(torch.from_numpy(a) for a in (s_pad, noise_shift, spdiag)))
    q = logz.beta_table_padded(*(torch.from_numpy(a) for a in (s_pad, noise_pad, spdiag)))
    v_p = sp.alpha_table_padded(jnp.asarray(s_pad), jnp.asarray(noise_shift), jnp.asarray(spdiag))
    q_p = sp.beta_table_padded(jnp.asarray(s_pad), jnp.asarray(noise_pad), jnp.asarray(spdiag))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_p), atol=2e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_p), atol=2e-4)

    # the real block against the JAX scan; padded lanes stay at logZ 0
    _, v_s, q_s = jsemicrf._forward_backward(jnp.asarray(s), jnp.asarray(n))
    np.testing.assert_allclose(v.numpy()[:t, :nb], np.asarray(v_s), atol=2e-4)
    np.testing.assert_allclose(q.numpy()[:t, :nb], np.asarray(q_s), atol=2e-4)
    np.testing.assert_allclose(v.numpy()[tp - 1, :nb], np.asarray(v_s)[-1], atol=2e-4)
    np.testing.assert_array_equal(v.numpy()[:, nb:], 0.0)

    # the port's own scan (the test oracle of the unpadded API)
    v_port = semicrf._alpha_scan(torch.from_numpy(s), torch.from_numpy(n))
    np.testing.assert_allclose(v_port.numpy(), np.asarray(v_s), atol=2e-4)


def test_log_z_and_marginals_match_jax():
    rng = np.random.default_rng(1)
    s, n = _scores(rng, 24, 4)
    s_t = torch.from_numpy(s).requires_grad_()
    n_t = torch.from_numpy(n).requires_grad_()
    lz = semicrf.log_z(s_t, n_t)
    lz.sum().backward()
    lz_j, (gs_j, gn_j) = jax.value_and_grad(
        lambda a, b: jsemicrf.log_z(a, b).sum(), argnums=(0, 1)
    )(jnp.asarray(s), jnp.asarray(n))
    np.testing.assert_allclose(lz.detach().numpy().sum(), float(lz_j), rtol=1e-5)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(gs_j), atol=1e-3)
    np.testing.assert_allclose(n_t.grad.numpy(), np.asarray(gn_j), atol=1e-3)

    # the autograd oracle and the marginals agree with the exact backward
    s2 = torch.from_numpy(s).requires_grad_()
    semicrf.log_z_slow(s2, torch.from_numpy(n)).sum().backward()
    np.testing.assert_allclose(s2.grad.numpy(), np.asarray(gs_j), atol=1e-3)
    _, marg, marg_noise = semicrf.marginals(torch.from_numpy(s), torch.from_numpy(n))
    np.testing.assert_allclose(marg.numpy(), np.asarray(gs_j), atol=1e-3)
    np.testing.assert_allclose(marg_noise.numpy(), np.asarray(gn_j), atol=1e-3)


def test_log_z_padded_contract_matches_jax():
    """Value and cotangents of ``log_z_padded`` against ``jax.grad`` of
    ``log_z_padded_best`` on the same padded inputs: padded lanes give logZ
    0 and a zero score cotangent; the noise cotangent is zero from row
    t-1 on."""
    t, nb, tp, nbp = 21, 5, 24, 128
    rng = np.random.default_rng(2)
    s, n = _scores(rng, t, nb)
    s_pad, noise_pad = _pad(s, n, tp, nbp)
    w = rng.normal(size=nbp).astype(np.float32)  # a cotangent on every lane

    s_t = torch.from_numpy(s_pad).requires_grad_()
    n_t = torch.from_numpy(noise_pad).requires_grad_()
    lz = logz.log_z_padded(t, s_t, n_t)
    (lz * torch.from_numpy(w)).sum().backward()

    lz_j, (gs_j, gn_j) = jax.value_and_grad(
        lambda a, b: (jsemicrf.log_z_padded_best(t, a, b) * w).sum(), argnums=(0, 1)
    )(jnp.asarray(s_pad), jnp.asarray(noise_pad))
    lz_jv = jsemicrf.log_z_padded_best(t, jnp.asarray(s_pad), jnp.asarray(noise_pad))
    np.testing.assert_allclose(lz.detach().numpy(), np.asarray(lz_jv), atol=1e-3)
    np.testing.assert_allclose(lz.detach().numpy()[nb:], 0.0, atol=1e-6)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(gs_j), atol=1e-3)
    np.testing.assert_allclose(n_t.grad.numpy(), np.asarray(gn_j), atol=1e-3)
    np.testing.assert_array_equal(s_t.grad.numpy()[:, :, nb:], 0.0)
    np.testing.assert_array_equal(n_t.grad.numpy()[t - 1 :], 0.0)

    # and against the unpadded scan logZ of the real block
    lz_real = jsemicrf.log_z(jnp.asarray(s), jnp.asarray(n))
    np.testing.assert_allclose(lz.detach().numpy()[:nb], np.asarray(lz_real), atol=1e-3)


def test_eval_path_matches_jax():
    t, nb = 30, 6
    rng = np.random.default_rng(3)
    s, n = _scores(rng, t, nb)
    intervals = []
    for _ in range(nb):
        cuts = np.sort(rng.choice(t, size=8, replace=False))
        intervals.append([(int(a), int(b)) for a, b in zip(cuts[::2], cuts[1::2])])
    intervals[1] = []  # an empty track
    begins, ends, mask = semicrf.pad_intervals(intervals, k=8)
    want = jsemicrf.eval_path_padded(
        jnp.asarray(s), jnp.asarray(n), jnp.asarray(begins), jnp.asarray(ends), jnp.asarray(mask)
    )
    got = semicrf.eval_path_padded(
        torch.from_numpy(s), torch.from_numpy(n),
        torch.from_numpy(begins), torch.from_numpy(ends), torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    slow = semicrf.eval_path_slow(intervals, torch.from_numpy(s), torch.from_numpy(n))
    np.testing.assert_allclose(slow.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    crf = semicrf.NeuralSemiCRFInterval(torch.from_numpy(s), torch.from_numpy(n))
    want_lp = jsemicrf.NeuralSemiCRFInterval(jnp.asarray(s), jnp.asarray(n)).logProb(intervals)
    np.testing.assert_allclose(crf.logProb(intervals).numpy(), np.asarray(want_lp), atol=1e-3)


@pytest.mark.parametrize("t,nb", [(21, 5), (9, 130)])
def test_unpadded_log_z_with_noise_matches_jax(t, nb):
    """``logz.log_z`` (the V1 route: unpadded score and a learned, nonzero
    noise, padded once; the alpha and beta tables' plain versions on a CPU
    tensor) against the JAX package's ``semicrf.log_z`` and ``jax.grad``:
    logZ within 1e-5 relative, the score and noise cotangents within
    1e-5 * max(1, max |cotangent|); the value also against the Pallas route
    (``semicrf_pallas.log_z``, in interpret mode)."""
    rng = np.random.default_rng(t + 7)
    s, n = _scores(rng, t, nb)
    n += 0.3  # skips that outweigh the intervals on some steps
    w = rng.uniform(0.5, 1.5, size=nb).astype(np.float32)
    s_t = torch.from_numpy(s).requires_grad_()
    n_t = torch.from_numpy(n).requires_grad_()
    lz = logz.log_z(s_t, n_t)
    (lz * torch.from_numpy(w)).sum().backward()
    lz_j, (gs_j, gn_j) = jax.value_and_grad(
        lambda a, b: (jsemicrf.log_z(a, b) * w).sum(), argnums=(0, 1)
    )(jnp.asarray(s), jnp.asarray(n))
    want = np.asarray(jsemicrf.log_z(jnp.asarray(s), jnp.asarray(n)))
    assert lz.shape == (nb,) and s_t.grad.shape == s.shape and n_t.grad.shape == n.shape
    np.testing.assert_allclose(lz.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(lz.detach().numpy(), np.asarray(sp.log_z(jnp.asarray(s), jnp.asarray(n))),
                               rtol=1e-5)
    for got, g in ((s_t.grad.numpy(), np.asarray(gs_j)), (n_t.grad.numpy(), np.asarray(gn_j))):
        assert np.abs(got - g).max() <= 1e-5 * max(1.0, np.abs(g).max())
    assert np.abs(n_t.grad.numpy()).max() > 0.1  # the noise cotangent is not trivial


def test_best_routes_dispatch_by_device():
    """``log_z_best`` and ``viterbi_backward_tables_best`` on CPU tensors are
    the plain routes (the scan logZ, the padded DP), launch nothing, and
    refuse a device that has neither route."""
    rng = np.random.default_rng(11)
    s, n = (torch.from_numpy(a) for a in _scores(rng, 17, 4))
    launches = (logz.alpha_launches, logz.beta_launches)
    assert torch.equal(semicrf.log_z_best(s, n), semicrf.log_z(s, n))
    for got, want in zip(semicrf.viterbi_backward_tables_best(s, n), semicrf.viterbi_backward_tables(s, n)):
        assert torch.equal(got, want)
    assert (logz.alpha_launches, logz.beta_launches) == launches
    for fn in (semicrf.log_z_best, semicrf.viterbi_backward_tables_best):
        with pytest.raises(ValueError, match="meta"):
            fn(s.to("meta"), n.to("meta"))


@pytest.mark.parametrize("t,nb", [(10, 3), (40, 7)])
def test_viterbi_route_1b_matches_jax(t, nb):
    """Unpadded alpha-layout scores through the pad-and-transpose wrapper:
    the same pointer tables as the JAX scan, and decoded paths as the JAX
    wrapper's."""
    rng = np.random.default_rng(t + 100)
    s, n = _scores(rng, t, nb)
    ptr, diag = semicrf.viterbi_backward_tables(torch.from_numpy(s), torch.from_numpy(n))
    ptr_j, diag_j = jsemicrf.viterbi_backward_tables(jnp.asarray(s), jnp.asarray(n))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(ptr_j))
    np.testing.assert_array_equal(diag.numpy(), np.asarray(diag_j))
    crf = semicrf.NeuralSemiCRFInterval(torch.from_numpy(s), torch.from_numpy(n))
    assert crf.decode() == jsemicrf.NeuralSemiCRFInterval(jnp.asarray(s), jnp.asarray(n)).decode()


# the training batch [696,696,384], the ragged ones (any Tp >= 1), one lane
# group, more lane groups than SMs, and the V1 training batch of 2
@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp,nbp", [(696, 384), (128, 256), (45, 256), (1, 128), (128, None), (64, 8192),
                                    (696, 256)])
def test_beta_launch_plan_covers_every_lane_and_term(tp, nbp, dtype, n_sm):
    from test_torch_viterbi import check_plan
    from transkun_tpu_torch.ops import _build, _cluster

    lanes = _cluster.lanes_per_cta(dtype)
    nbp = nbp or lanes
    plan = logz.launch_plan(tp, nbp, dtype, n_sm)
    assert plan.groups * plan.lanes == nbp
    check_plan(plan, tp, nbp, n_sm, _build.SMEM_LIMIT)


# the training batch [696,696,384], the V1 training batch of 2 [696,696,256],
# a small one and a ragged Tp (the last block part full)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp,nbp", [(696, 384), (696, 256), (64, 256), (125, 256)])
def test_alpha_launch_plan_covers_every_lane_and_term(tp, nbp, dtype):
    """The alpha kernel's plan on an H100's 132 SMs (``model_max_clusters``):
    every lane in one group, every m < k0 reduced once across the ranks and
    slots, the TMA boxes of each rank load exactly its owned m < k0 (each
    once, ``rows`` a box) within the TMA unit's limits (a traversal of at
    most 256 elements and a stride of at most 8 a dimension, 16-byte inner
    rows), and shared memory within the limit."""
    from test_torch_viterbi import check_plan
    from transkun_tpu_torch.ops import _build, _cluster

    n_sm = 132
    plan = logz.alpha_launch_plan(tp, nbp, dtype, n_sm, max_clusters=_cluster.model_max_clusters(n_sm))
    assert plan == logz.alpha_launch_plan(tp, nbp, dtype, n_sm)
    size = torch.empty((), dtype=dtype).element_size()
    assert plan.lanes * size == plan.row_bytes == _cluster.ALPHA_ROW_BYTES[dtype]
    assert plan.groups * plan.lanes == nbp
    check_plan(plan, tp, nbp, n_sm, _build.SMEM_LIMIT, _cluster.ALPHA_CLUSTER_SIZES)
    assert plan.stages == _cluster.ALPHA_STAGES and plan.rows == 2 * plan.slots
    assert all(1 <= b <= _cluster.TMA_MAX_BOX for b in plan.box)
    assert all(1 <= e <= _cluster.TMA_MAX_STRIDE for e in plan.element_strides)
    assert plan.box[0] * size % 16 == 0 and plan.element_strides[0] == 1
    assert plan.box[2] == _cluster.BLOCK
    for k0 in range(0, tp, _cluster.BLOCK):
        for rank in range(plan.cluster):
            boxes = _cluster.boxes_of_block(plan, rank, k0)
            assert all(len(b) == plan.rows for b in boxes)  # ceil(traversal / stride)
            loaded = [m for b in boxes for m in b if m < k0]
            assert loaded == list(range(rank, k0, plan.cluster))
    if (tp, nbp) == (696, 384):  # the training batch: the beta kernel's grid
        beta = logz.launch_plan(tp, nbp, dtype, n_sm)
        assert (plan.cluster, plan.ctas) == (beta.cluster, beta.ctas)
        assert plan.ctas == 96 if dtype == torch.float32 else plan.cluster == 5
