"""The port's CUDA kernels against their plain PyTorch versions, on the card;
the Viterbi kernel also on tie-heavy inputs, and the Viterbi, alpha and beta
kernels at every cluster size and at the cluster edges (one lane group; more
lane groups than SMs; a ragged Tp), and on the V1 model's routes (unpadded
scores, a learned noise) at its shapes and tails; the walk kernel (the
decode's stitching chain) against ``walk_group_plain``, as integers; the
attention kernels, the streaming ones also at the edges of their tiles,
key splits and head dims, run twice and with handed and fetched row
statistics for the same bits; a two-rank gloo training step with both ranks
on one card (``tests/_torch_dist_ranks.py``), whose ranks must hold the same
parameters; the semi-CRF example (``crf_minimal_example``) against its plain
version; the training link's ``dequantize_int16`` over every int16 value.

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from transkun_tpu_torch.ops import logz, semicrf, softmax, viterbi, walk

NEG = -1e30


def _decode_inputs(rng, t, nbp, dev):
    """NEG-padded decode-layout inputs with ragged t and every lane real."""
    tp = -(-t // 8) * 8
    s_t = np.full((tp, tp, nbp), NEG, np.float32)
    s_t[:t, :t] = rng.normal(size=(t, t, nbp))
    noise = np.zeros((tp, nbp), np.float32)
    noise[: t - 1] = rng.normal(size=(t - 1, nbp)) * 0.1
    diag = np.zeros((tp, nbp), np.float32)
    diag[:t] = np.einsum("iin->in", s_t[:t, :t])
    return [torch.from_numpy(a).to(dev) for a in (s_t, noise, diag * (diag > 0))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t,nbp", [(691, 128), (123, 256)])
def test_kernel_equals_plain(cuda, t, nbp):
    args = _decode_inputs(np.random.default_rng(t), t, nbp, cuda)
    before = viterbi.launches
    got = viterbi.viterbi_backward_tables_padded(*args)
    torch.cuda.synchronize()
    assert viterbi.launches == before + 1
    assert torch.equal(got, viterbi.viterbi_backward_tables_plain(*args))  # exact


@pytest.mark.gpu
@pytest.mark.parametrize("t,nbp", [(691, 128), (123, 256)])
def test_kernel_equals_plain_from_bf16_scores(cuda, t, nbp):
    """The scores rounded to bf16, the gate from the rounded diagonal: the
    kernel upcasts as it loads, and the table equals the plain version's
    and the fp32 kernel's on the upcast tensor, exactly."""
    s_t, noise, _ = _decode_inputs(np.random.default_rng(t), t, nbp, cuda)
    s_b = s_t.bfloat16()
    diag = torch.diagonal(s_b).t().float().contiguous()
    gate = diag * (diag > 0)
    before = viterbi.launches
    got = viterbi.viterbi_backward_tables_padded(s_b, noise, gate)
    torch.cuda.synchronize()
    assert viterbi.launches == before + 1
    assert torch.equal(got, viterbi.viterbi_backward_tables_plain(s_b, noise, gate))
    assert torch.equal(got, viterbi.viterbi_backward_tables_padded(s_b.float(), noise, gate))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    s_t, noise, diag = _decode_inputs(np.random.default_rng(0), 20, 128, cuda)
    with pytest.raises(TypeError):
        viterbi.viterbi_backward_tables_padded(s_t.double(), noise, diag)
    with pytest.raises(TypeError):  # fp32 or bf16 scores only
        viterbi.viterbi_backward_tables_padded(s_t.half(), noise, diag)
    with pytest.raises(TypeError):  # noise and the gate stay fp32
        viterbi.viterbi_backward_tables_padded(s_t.bfloat16(), noise.bfloat16(), diag)
    with pytest.raises(ValueError):
        viterbi.viterbi_backward_tables_padded(s_t[:, :, :96], noise[:, :96], diag[:, :96])
    with pytest.raises(ValueError):
        viterbi.viterbi_backward_tables_padded(s_t, noise.cpu(), diag)


def _table_inputs(rng, t, nbp, nb_real, dev):
    """NEG-padded alpha-layout scores with ragged t, lanes past ``nb_real``
    padded, and the shifted noise, the noise and softplus(diag)."""
    tp = -(-t // 8) * 8
    s = np.full((tp, tp, nbp), NEG, np.float32)
    s[:t, :t, :nb_real] = rng.normal(size=(t, t, nb_real))
    noise = np.zeros((tp, nbp), np.float32)
    noise[: t - 1, :nb_real] = rng.normal(size=(t - 1, nb_real)) * 0.1
    spdiag = np.logaddexp(np.einsum("iin->in", s), 0.0).astype(np.float32)
    shift = np.concatenate([np.zeros_like(noise[:1]), noise[:-1]])
    return [torch.from_numpy(a).to(dev) for a in (s, shift, noise, spdiag)]


def _assert_table_close(got, want):
    """|kernel - plain| <= 1e-5 * max(1, |plain|): sums in another order."""
    bound = 1e-5 * torch.clamp(want.abs(), min=1.0)
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("t,nbp,nb_real", [(691, 384, 360), (123, 256, 200)])
def test_logz_kernels_equal_plain(cuda, t, nbp, nb_real):
    s, shift, noise, spdiag = _table_inputs(np.random.default_rng(t), t, nbp, nb_real, cuda)
    a0, b0 = logz.alpha_launches, logz.beta_launches
    v = logz.alpha_table_padded(s, shift, spdiag)
    q = logz.beta_table_padded(s, noise, spdiag)
    torch.cuda.synchronize()
    assert (logz.alpha_launches, logz.beta_launches) == (a0 + 1, b0 + 1)
    _assert_table_close(v, logz.alpha_table_padded_plain(s, shift, spdiag))
    _assert_table_close(q, logz.beta_table_padded_plain(s, noise, spdiag))
    assert bool((v[:, nb_real:] == 0).all()) and bool((q[:, nb_real:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("t,nbp,nb_real", [(691, 384, 360), (123, 256, 200)])
def test_logz_kernels_equal_plain_from_bf16_scores(cuda, t, nbp, nb_real):
    """bf16 scores, spdiag from the rounded diagonal: within the fp32 bound
    of the plain versions (which upcast the same bits), and equal to the
    fp32 kernels on the upcast tensor bit for bit (each at the bf16
    launch's cluster size: the cluster splits each lane's sum, and the two
    types are planned apart); then ``log_z_padded`` gives a bf16 score
    cotangent that is zero on the padded lanes."""
    s, shift, noise, _ = _table_inputs(np.random.default_rng(t), t, nbp, nb_real, cuda)
    s_b = s.bfloat16()
    spdiag = torch.nn.functional.softplus(torch.diagonal(s_b).t().float()).contiguous()
    a0, b0 = logz.alpha_launches, logz.beta_launches
    v = logz.alpha_table_padded(s_b, shift, spdiag)
    q = logz.beta_table_padded(s_b, noise, spdiag)
    torch.cuda.synchronize()
    assert (logz.alpha_launches, logz.beta_launches) == (a0 + 1, b0 + 1)
    _assert_table_close(v, logz.alpha_table_padded_plain(s_b, shift, spdiag))
    _assert_table_close(q, logz.beta_table_padded_plain(s_b, noise, spdiag))
    cluster = logz.alpha_card_plan(s_b).cluster
    assert torch.equal(v, logz.alpha_table_padded_cuda(s_b.float(), shift, spdiag, cluster=cluster))
    cluster = logz.beta_card_plan(s_b).cluster
    assert torch.equal(q, logz.beta_table_padded_cuda(s_b.float(), noise, spdiag, cluster=cluster))
    s_b.requires_grad_()
    logz.log_z_padded(t, s_b, noise).sum().backward()
    assert s_b.grad.dtype == torch.bfloat16 and bool(torch.isfinite(s_b.grad).all())
    assert bool((s_b.grad[:, :, nb_real:] == 0).all())


@pytest.mark.gpu
def test_logz_kernels_reject_what_they_do_not_take(cuda):
    s, shift, noise, spdiag = _table_inputs(np.random.default_rng(0), 20, 128, 128, cuda)
    for fn, rows in ((logz.alpha_table_padded, shift), (logz.beta_table_padded, noise)):
        with pytest.raises(TypeError):
            fn(s.double(), rows, spdiag)
        with pytest.raises(TypeError):  # fp32 or bf16 scores only
            fn(s.half(), rows, spdiag)
        with pytest.raises(TypeError):  # the other tensors stay fp32
            fn(s.bfloat16(), rows, spdiag.bfloat16())
        with pytest.raises(ValueError):  # lanes not a multiple of 32
            fn(s[:, :, :100].contiguous(), rows[:, :100].contiguous(), spdiag[:, :100].contiguous())
        with pytest.raises(ValueError):  # non-contiguous
            fn(s.transpose(0, 1), rows, spdiag)
        with pytest.raises(ValueError):  # wrong shape
            fn(s, rows[:-1], spdiag)
        with pytest.raises(ValueError):  # another device
            fn(s, rows.cpu(), spdiag)


# -- the blocked cluster kernels (Viterbi, beta): ties, cluster edges ---------

# one lane group (NBp = the lanes of one CTA), and more lane groups than SMs
CLUSTER_EDGES = [(123, None), (61, 8192)]
DTYPES = [torch.float32, torch.bfloat16]


def _tie_inputs(rng, t, nbp, dev):
    """Decode inputs with small-integer scores and noise (exact in bf16):
    equal candidates abound, so every tie rule is exercised."""
    tp = -(-t // 8) * 8
    s_t = np.full((tp, tp, nbp), NEG, np.float32)
    s_t[:t, :t] = rng.integers(-3, 3, size=(t, t, nbp))
    noise = np.zeros((tp, nbp), np.float32)
    noise[: t - 1] = rng.integers(-1, 2, size=(t - 1, nbp))
    diag = np.zeros((tp, nbp), np.float32)
    diag[:t] = np.einsum("iin->in", s_t[:t, :t])
    return [torch.from_numpy(a).to(dev) for a in (s_t, noise, diag * (diag > 0))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,nbp", [(691, 128), (123, 256)])
def test_kernel_equals_plain_on_ties(cuda, t, nbp, dtype):
    s_t, noise, gate = _tie_inputs(np.random.default_rng(t), t, nbp, cuda)
    s_t = s_t.to(dtype)
    got = viterbi.viterbi_backward_tables_cuda(s_t, noise, gate)
    again = viterbi.viterbi_backward_tables_cuda(s_t, noise, gate)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, viterbi.viterbi_backward_tables_plain(s_t, noise, gate))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,nbp", CLUSTER_EDGES)
def test_kernel_equals_plain_at_cluster_edges(cuda, t, nbp, dtype):
    from transkun_tpu_torch.ops import _cluster

    nbp = nbp or _cluster.lanes_per_cta(dtype)
    for args in (_decode_inputs(np.random.default_rng(t), t, nbp, cuda),
                 _tie_inputs(np.random.default_rng(t), t, nbp, cuda)):
        args[0] = args[0].to(dtype)
        got = viterbi.viterbi_backward_tables_cuda(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, viterbi.viterbi_backward_tables_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,nbp", CLUSTER_EDGES)
def test_beta_kernel_equals_plain_at_cluster_edges(cuda, t, nbp, dtype):
    from transkun_tpu_torch.ops import _cluster

    nbp = nbp or _cluster.lanes_per_cta(dtype)
    s, _, noise, spdiag = _table_inputs(np.random.default_rng(t), t + 2, nbp, nbp, cuda)
    s = s.to(dtype)
    got = logz.beta_table_padded_cuda(s, noise, spdiag)
    again = logz.beta_table_padded_cuda(s, noise, spdiag)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_table_close(got, logz.beta_table_padded_plain(s, noise, spdiag))


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 5, 7, 8, 12, 16])
def test_cluster_kernels_at_every_cluster_size(cuda, cluster):
    """Every cluster size gives the plain version's tables; with one CTA a
    group a thread takes its ends in more than one round of loads."""
    args = _tie_inputs(np.random.default_rng(cluster), 691, 128, cuda)
    got = viterbi.viterbi_backward_tables_cuda(*args, cluster=cluster)
    s, _, noise, spdiag = _table_inputs(np.random.default_rng(cluster), 301, 64, 64, cuda)
    # a ragged Tp of 301: the last block (t = 0 .. 4) is part full
    s, noise, spdiag = s[:301, :301].contiguous(), noise[:301].contiguous(), spdiag[:301].contiguous()
    q = logz.beta_table_padded_cuda(s, noise, spdiag, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, viterbi.viterbi_backward_tables_plain(*args))
    _assert_table_close(q, logz.beta_table_padded_plain(s, noise, spdiag))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_launch_plans_match_the_libraries(cuda, dtype):
    """The shared memory that the host plans is what the kernels lay out."""
    from transkun_tpu_torch.ops import _cluster

    n_sm = _cluster.sm_count(cuda.index or 0)
    bf16 = int(dtype == torch.bfloat16)
    for tp, nbp in ((696, 128), (696, 384), (45, 256)):
        vp, bp = viterbi.launch_plan(-(-tp // 8) * 8, nbp, dtype, n_sm), logz.launch_plan(tp, nbp, dtype, n_sm)
        assert viterbi._library().viterbi_bwd_smem_bytes(-(-tp // 8) * 8, vp.cluster, bf16) == vp.smem
        assert logz._library("semicrf_beta").semicrf_beta_smem_bytes(tp, bp.cluster, bf16) == bp.smem
        ap = logz.alpha_launch_plan(tp, nbp, dtype, n_sm)
        assert logz._library("semicrf_alpha").semicrf_alpha_smem_bytes(tp, ap.cluster, bf16) == ap.smem


# -- the alpha kernel (blocked over a cluster, far scores by TMA) --------------

def _alpha_twice(s, shift, spdiag, cluster=None):
    """Two launches of the alpha kernel, which must count two launches and
    give the same bits; returns the table."""
    before = logz.alpha_launches
    got = logz.alpha_table_padded_cuda(s, shift, spdiag, cluster=cluster)
    again = logz.alpha_table_padded_cuda(s, shift, spdiag, cluster=cluster)
    torch.cuda.synchronize()
    assert logz.alpha_launches == before + 2
    assert torch.equal(got, again)
    return got


@pytest.fixture(scope="module")
def training_batch():
    """The training batch's alpha inputs [696,696,384] (t = 691, 360 real
    lanes), made once: (fp32 scores, shifted noise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s, shift, _, _ = _table_inputs(np.random.default_rng(691), 691, 384, 360, torch.device("cuda"))
    return s, shift


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 5, 6, 7, 8])
def test_alpha_kernel_at_every_cluster_size(training_batch, cluster, dtype):
    """The training batch at every cluster size the plan allows: a box of
    32 owned begins traverses 32 * C <= 256."""
    s, shift = training_batch
    s = s.to(dtype)
    spdiag = torch.nn.functional.softplus(torch.diagonal(s).t().float()).contiguous()
    got = _alpha_twice(s, shift, spdiag, cluster)
    _assert_table_close(got, logz.alpha_table_padded_plain(s, shift, spdiag))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,nbp", CLUSTER_EDGES + [(125, 256)])
def test_alpha_kernel_equals_plain_at_cluster_edges(cuda, t, nbp, dtype):
    """One lane group, more lane groups than SMs, and Tp = 125 (not a
    multiple of 8: the last block part full, boxes past the last end)."""
    from transkun_tpu_torch.ops import _cluster

    nbp = nbp or _cluster.lanes_per_cta(dtype, _cluster.ALPHA_ROW_BYTES[dtype])
    s, shift, _, spdiag = _table_inputs(np.random.default_rng(t), t + 2, nbp, nbp, cuda)
    if t == 125:
        s, shift, spdiag = s[:125, :125].contiguous(), shift[:125].contiguous(), spdiag[:125].contiguous()
    s = s.to(dtype)
    got = _alpha_twice(s, shift, spdiag)
    _assert_table_close(got, logz.alpha_table_padded_plain(s, shift, spdiag))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_log_z_padded_through_the_kernels_equals_the_cpu_route(cuda, dtype):
    """logZ and its score and noise cotangents through the alpha and beta
    kernels against the same function on the CPU (the plain versions).
    logZ within 1e-5 relative, as the tables; the cotangents, which
    exponentiate sums of table entries each within 1e-5 * |v|, within 1e-4
    (``chip_smoke.py``'s bound for the logZ gradient), and a bf16 cotangent
    also within one bf16 spacing (2**-7 relative), which such a difference
    can flip."""
    t = 123
    s, _, noise, _ = _table_inputs(np.random.default_rng(5), t, 256, 200, cuda)
    s = s.to(dtype)
    w = torch.from_numpy(np.random.default_rng(6).uniform(0.5, 1.5, 256).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        s_d, noise_d = (a.detach().to(dev).requires_grad_() for a in (s, noise))
        a0 = logz.alpha_launches
        lz = logz.log_z_padded(t, s_d, noise_d)
        (lz * w.to(dev)).sum().backward()
        assert logz.alpha_launches == a0 + (dev.type == "cuda")
        grads.append([x.detach().float().cpu() for x in (lz, s_d.grad, noise_d.grad)])
    tolerances = ((1e-5, 1e-5), (0.0 if dtype == torch.float32 else 2**-7, 1e-4), (0.0, 1e-4))
    for got, want, (rtol, atol) in zip(*grads, tolerances):
        assert torch.allclose(got, want, rtol=rtol, atol=atol), float((got - want).abs().max())


# -- the V1 routes: unpadded scores and a learned noise ------------------------

# a V1 decode segment (20 s, t = 863) and the tails of a 64 s piece (13.9 s
# and 3.9 s), and the shortest tail (a few samples: t = 2)
V1_DECODE_T = [863, 602, 171, 2]


def _v1_scores(rng, t, nb, dev):
    """Unpadded alpha-layout scores [t, t, nb] and a nonzero noise [t-1, nb]
    that outweighs the intervals on some steps."""
    s = rng.normal(size=(t, t, nb)).astype(np.float32)
    n = (rng.normal(size=(t - 1, nb)) * 0.5 + 0.3).astype(np.float32)
    return torch.from_numpy(s).to(dev), torch.from_numpy(n).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("t", V1_DECODE_T)
def test_viterbi_best_at_the_v1_shapes(cuda, t):
    """``viterbi_backward_tables_best`` on CUDA tensors launches the kernel
    once on the padded decode layout, and its tables equal the plain
    version's on the same layout and the CPU route's, bit for bit."""
    s, n = _v1_scores(np.random.default_rng(t), t, 90, cuda)
    before = viterbi.launches
    ptr, diag = semicrf.viterbi_backward_tables_best(s, n)
    torch.cuda.synchronize()
    assert viterbi.launches == before + 1 and ptr.shape == (t - 1, 90)
    want = viterbi.viterbi_backward_tables_plain(*semicrf.decode_layout(s, n))[: t - 1, :90]
    assert torch.equal(ptr, want)
    ptr_cpu, diag_cpu = semicrf.viterbi_backward_tables_best(s.cpu(), n.cpu())
    assert torch.equal(ptr.cpu(), ptr_cpu) and torch.equal(diag.cpu(), diag_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("t,nb", [(691, 180), (123, 90), (2, 90)])
def test_log_z_best_through_the_kernels_equals_the_cpu_route(cuda, t, nb):
    """``log_z_best`` on CUDA tensors (the V1 training route: the unpadded
    ``logz.log_z``, one alpha and one beta launch) against the CPU route
    (the scan ``log_z``) on the same tensors, at the V1 training batch of 2
    (180 lanes) and smaller: logZ within 1e-5 relative, the score and the
    noise cotangents within 1e-4, the bounds of
    ``test_log_z_padded_through_the_kernels_equals_the_cpu_route``, or
    2 * 2**-24 * sqrt(t) * max |logZ| where that is larger (the exact
    marginals add table entries of logZ's size, each carrying the fp32
    roundings of its chain: ``chip_smoke.py``'s ``cotangent_tolerance``;
    at t = 691 both routes' logZ reach 1383 and they differ by 2.3e-3)."""
    s, n = _v1_scores(np.random.default_rng(t + 1), t, nb, cuda)
    w = torch.from_numpy(np.random.default_rng(t + 2).uniform(0.5, 1.5, nb).astype(np.float32))
    out = []
    for dev in (cuda, torch.device("cpu")):
        s_d, n_d = (a.detach().to(dev).requires_grad_() for a in (s, n))
        a0, b0 = logz.alpha_launches, logz.beta_launches
        lz = semicrf.log_z_best(s_d, n_d)
        (lz * w.to(dev)).sum().backward()
        launched = dev.type == "cuda"
        assert (logz.alpha_launches, logz.beta_launches) == (a0 + launched, b0 + launched)
        out.append([x.detach().cpu() for x in (lz, s_d.grad, n_d.grad)])
    g_tol = max(1e-4, 2 * 2**-24 * np.sqrt(t) * float(out[1][0].abs().max()))
    for got, want, (rtol, atol) in zip(*out, ((1e-5, 1e-5), (0.0, g_tol), (0.0, g_tol))):
        assert torch.allclose(got, want, rtol=rtol, atol=atol), float((got - want).abs().max())


# -- fused attention and MLP --------------------------------------------------

ATTN_SHAPES = [  # b, sq, skv, heads, head_dim
    (89, 149, 149, 8, 32),  # flagship F-attention, one segment
    (149, 89, 89, 8, 32),  # flagship T-attention
    (356, 149, 149, 8, 32),  # the same at --batchSize 4
    (596, 89, 89, 8, 32),
    (5, 37, 61, 3, 8),  # ragged: cross-attention, odd lengths, 3 heads
    (4, 61, 37, 2, 16),  # more queries than keys
    (3, 7, 13, 2, 40),  # head_dim above a warp, padded to 64
    (2, 300, 200, 2, 32),  # long: more keys than a thread's registers hold
    (2, 33, 21, 2, 80),  # head_dim above the tensor-core and streaming kernels' 64
    (2, 100, 180, 2, 80),  # both
]
# the variant the library picks where it is not the tensor-core one
ATTN_PICKED = {(2, 300, 200, 2, 32): "stream", (2, 33, 21, 2, 80): "general",
               (2, 100, 180, 2, 80): "general"}


def _attn_inputs(rng, b, sq, skv, d, dev, dtype=torch.float32):
    shapes = [(b, sq, d), (b, skv, d), (b, skv, d), (b, sq, d)]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev).to(dtype) for s in shapes]


def _bf16_spacing_at_max(x) -> float:
    """The bf16 spacing at the largest |value| of ``x``."""
    return 2.0 ** (int(np.frexp(float(x.float().abs().max()))[1]) - 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,dh", ATTN_SHAPES)
def test_attention_kernels_equal_plain(cuda, b, sq, skv, h, dh, dtype):
    """Through the autograd function as the model calls it.  fp32: forward
    within 2e-5 and dq, dk, dv within 1e-4 of the plain versions on
    unit-normal inputs (sums in another order, products on the tensor cores
    from split operands).  bf16: the kernels and the plain versions take
    the same bf16 bits to fp32 and round once, so an output may land on the
    neighbouring bf16 value: one bf16 spacing of its largest value."""
    from transkun_tpu_torch.ops import attention

    q, k, v, do = _attn_inputs(np.random.default_rng(sq), b, sq, skv, h * dh, cuda, dtype)
    scale = 1.0 / np.sqrt(dh)
    want_variant = ATTN_PICKED.get((b, sq, skv, h, dh), "mma")
    assert attention.kernel_variant("attention_fwd", sq, skv, dh) == want_variant
    assert attention.kernel_variant("attention_bwd", sq, skv, dh) == want_variant
    f0 = dict(attention.fwd_launches_by_variant)
    b0 = dict(attention.bwd_launches_by_variant)
    for a in (q, k, v):
        a.requires_grad_()
    o = attention.fused_attention(q, k, v, h, scale)
    o.backward(do)
    torch.cuda.synchronize()
    for before, after in ((f0, attention.fwd_launches_by_variant),
                          (b0, attention.bwd_launches_by_variant)):
        assert after == {**before, want_variant: before[want_variant] + 1}
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    want = attention.attention_plain(qd, kd, vd, h, scale)
    # the backward kernel was given the forward kernel's o; so is the plain version
    grads = attention.attention_bwd_plain(qd, kd, vd, o.detach(), do, h, scale)
    for got, ref, atol in [(o.detach(), want, 2e-5)] + [
            (leaf.grad, g, 1e-4) for leaf, g in zip((q, k, v), grads)]:
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        allowed = atol if dtype == torch.float32 else _bf16_spacing_at_max(ref)
        assert float((got.float() - ref.float()).abs().max()) <= allowed


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["mma", "general", "stream"])
def test_attention_backward_twice_gives_the_same_bits(cuda, dtype, variant):
    """No output is accumulated by more than one warp and nothing goes
    through atomics: two runs are equal bit for bit, in every kernel."""
    from transkun_tpu_torch.ops import attention

    q, k, v, do = _attn_inputs(np.random.default_rng(7), 40, 149, 149, 256, cuda, dtype)
    scale = 1.0 / np.sqrt(32)
    o = attention.attention_fwd_cuda(q, k, v, 8, scale, variant=variant)
    first = attention.attention_bwd_cuda(q, k, v, o, do, 8, scale, variant=variant)
    second = attention.attention_bwd_cuda(q, k, v, o, do, 8, scale, variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(o, attention.attention_fwd_cuda(q, k, v, 8, scale, variant=variant))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_general_kernels_equal_plain_at_the_path_shape(cuda, dtype):
    """The general kernels, forced at a shape the tensor-core kernels take."""
    from transkun_tpu_torch.ops import attention

    q, k, v, do = _attn_inputs(np.random.default_rng(3), 20, 149, 89, 256, cuda, dtype)
    scale = 1.0 / np.sqrt(32)
    o = attention.attention_fwd_cuda(q, k, v, 8, scale, variant="general")
    grads = attention.attention_bwd_cuda(q, k, v, o, do, 8, scale, variant="general")
    want = attention.attention_plain(q, k, v, 8, scale)
    want_grads = attention.attention_bwd_plain(q, k, v, o, do, 8, scale)
    for got, ref, atol in [(o, want, 2e-5)] + [(g, w, 1e-4) for g, w in zip(grads, want_grads)]:
        allowed = atol if dtype == torch.float32 else _bf16_spacing_at_max(ref)
        assert got.dtype == dtype and float((got.float() - ref.float()).abs().max()) <= allowed


ATTN_STREAM_SHAPES = [  # b, sq, skv, heads, head_dim
    (5, 37, 61, 3, 8),  # small and ragged, forced: every tile part full
    (2, 70, 129, 2, 40),  # head_dim padded to 64, two query tiles, three key tiles
    (2, 89, 13261, 8, 32),  # the 0All branch at flagship width (N = 2)
    (1, 1500, 1500, 8, 32),  # past the general kernels' shared memory on both sides
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,dh", ATTN_STREAM_SHAPES)
def test_attention_stream_kernels_equal_plain(cuda, b, sq, skv, h, dh, dtype):
    """The streaming kernels (``variant="stream"``, the backward handed the
    forward's row statistics) against the plain versions, within the bounds
    of ``test_attention_kernels_equal_plain``; the library picks them by
    itself past the tensor-core kernels' 160 keys, and each call counts one
    launch of the variant."""
    from transkun_tpu_torch.ops import attention

    q, k, v, do = _attn_inputs(np.random.default_rng(skv), b, sq, skv, h * dh, cuda, dtype)
    scale = 1.0 / np.sqrt(dh)
    if skv > 160:
        for name in ("attention_fwd", "attention_bwd"):
            assert attention.kernel_variant(name, sq, skv, dh) == "stream"
    f0, b0 = attention.fwd_launches_by_variant["stream"], attention.bwd_launches_by_variant["stream"]
    o, stats = attention.attention_fwd_cuda(q, k, v, h, scale, variant="stream", with_stats=True)
    grads = attention.attention_bwd_cuda(q, k, v, o, do, h, scale, variant="stream", stats=stats)
    torch.cuda.synchronize()
    assert (attention.fwd_launches_by_variant["stream"],
            attention.bwd_launches_by_variant["stream"]) == (f0 + 1, b0 + 1)
    want = attention.attention_plain(q, k, v, h, scale)
    want_grads = attention.attention_bwd_plain(q, k, v, o, do, h, scale)
    for got, ref, atol in [(o, want, 2e-5)] + [(g, w, 1e-4) for g, w in zip(grads, want_grads)]:
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        allowed = atol if dtype == torch.float32 else _bf16_spacing_at_max(ref)
        assert float((got.float() - ref.float()).abs().max()) <= allowed


ATTN_STREAM_EDGES = [  # b, sq, skv, heads, head_dim: the plan's splits on the card
    (3, 37, 45, 2, 16),  # fewer keys than a tile
    (2, 89, 64 * 5 + 1, 8, 32),  # one key in the last tile, a split of its own
    (1, 5, 200, 1, 32),  # more splits wanted than key tiles: one a tile
    (3, 1, 1000, 4, 32),  # one query row
    (1, 89, 13261, 8, 32),  # 0All in transcription: 89 rows, one tile of 6 warps
    (2, 150, 700, 4, 16),  # head_dim 16, three query tiles
    (2, 150, 700, 2, 64),  # head_dim 64
    (1, 300, 1000, 8, 32),  # five query tiles, the keys in six splits of three tiles
    (2, 700, 700, 8, 32),  # 176 blocks of (b, h, query tile): one split
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,dh", ATTN_STREAM_EDGES)
def test_attention_stream_kernels_at_the_edges(cuda, b, sq, skv, h, dh, dtype):
    """The streaming kernels at the edges of their tiles, splits and head
    dims against the plain versions (the bounds of
    ``test_attention_kernels_equal_plain``), and the forward's statistics
    against ``attention_stats_plain``: the max within 1e-5 of max(1, |max|)
    and 1 / sum within 1e-5 relative (fp32 sums in another order)."""
    from transkun_tpu_torch.ops import attention

    q, k, v, do = _attn_inputs(np.random.default_rng(skv + sq), b, sq, skv, h * dh, cuda, dtype)
    scale = 1.0 / np.sqrt(dh)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = attention.stream_plan(b, h, sq, skv, dh, dtype, n_sm)
    assert [r for rng in plan.split_ranges() for r in range(*rng)] == list(range(plan.key_tiles))
    if (b, sq, skv) == (1, 5, 200):
        assert plan.splits == plan.key_tiles == 4
    if (b, sq, skv) == (2, 700, 700):
        assert plan.splits == 1
    o, stats = attention.attention_fwd_cuda(q, k, v, h, scale, variant="stream", with_stats=True)
    grads = attention.attention_bwd_cuda(q, k, v, o, do, h, scale, variant="stream", stats=stats)
    torch.cuda.synchronize()
    want = attention.attention_plain(q, k, v, h, scale)
    want_grads = attention.attention_bwd_plain(q, k, v, o, do, h, scale)
    for got, ref, atol in [(o, want, 2e-5)] + [(g, w, 1e-4) for g, w in zip(grads, want_grads)]:
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        allowed = atol if dtype == torch.float32 else _bf16_spacing_at_max(ref)
        assert float((got.float() - ref.float()).abs().max()) <= allowed
    want_stats = attention.attention_stats_plain(q, k, h, scale)
    assert stats.shape == want_stats.shape == (2, b * h, sq)
    assert float(((stats[0] - want_stats[0]).abs() / want_stats[0].abs().clamp(min=1.0)).max()) <= 1e-5
    assert float(((stats[1] - want_stats[1]).abs() / want_stats[1]).max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv", [(2, 89, 3000), (2, 700, 700)])
def test_attention_stream_kernels_give_the_same_bits(cuda, dtype, b, sq, skv):
    """The splits are joined in a fixed order and nothing goes through
    atomics: two forward runs give the same bits, and the backward gives the
    same bits twice with the forward's statistics handed to it and once
    without them (fetched by a launch of the forward kernel).  The first
    shape's keys are split, the second's are not."""
    from transkun_tpu_torch.ops import attention

    q, k, v, do = _attn_inputs(np.random.default_rng(5), b, sq, skv, 256, cuda, dtype)
    scale = 1.0 / np.sqrt(32)
    o, stats = attention.attention_fwd_cuda(q, k, v, 8, scale, variant="stream", with_stats=True)
    o2, stats2 = attention.attention_fwd_cuda(q, k, v, 8, scale, variant="stream", with_stats=True)
    handed = attention.attention_bwd_cuda(q, k, v, o, do, 8, scale, variant="stream", stats=stats)
    again = attention.attention_bwd_cuda(q, k, v, o, do, 8, scale, variant="stream", stats=stats)
    fetched = attention.attention_bwd_cuda(q, k, v, o, do, 8, scale, variant="stream")
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(stats, stats2)
    for a, c, e in zip(handed, again, fetched):
        assert torch.equal(a, c) and torch.equal(a, e)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv", [(2, 89, 333), (2, 700, 333)])
def test_attention_stream_kernels_at_very_negative_logits(cuda, b, sq, skv, dtype):
    """Every logit -20 * sqrt(32) = -113 (q = 20, k = -1 everywhere), so each
    row's max in log2 units is below -128 and 2^(-max) overflows: the keys
    past Skv in the last, partial tile must still add nothing.  The softmax
    is uniform, and the kernels' outputs are finite and within the bounds
    of ``test_attention_kernels_equal_plain`` of the plain versions.  The
    first shape splits the keys, the second does not."""
    from transkun_tpu_torch.ops import attention

    h, dh = 8, 32
    _, _, v, do = _attn_inputs(np.random.default_rng(skv), b, sq, skv, h * dh, cuda, dtype)
    q = torch.full((b, sq, h * dh), 20.0, device=cuda, dtype=dtype)
    k = torch.full((b, skv, h * dh), -1.0, device=cuda, dtype=dtype)
    scale = 1.0 / np.sqrt(dh)
    o, stats = attention.attention_fwd_cuda(q, k, v, h, scale, variant="stream", with_stats=True)
    grads = attention.attention_bwd_cuda(q, k, v, o, do, h, scale, variant="stream", stats=stats)
    torch.cuda.synchronize()
    assert float(stats[0].max()) < -128
    want = attention.attention_plain(q, k, v, h, scale)
    want_grads = attention.attention_bwd_plain(q, k, v, o, do, h, scale)
    for got, ref, atol in [(o, want, 2e-5)] + [(g, w, 1e-4) for g, w in zip(grads, want_grads)]:
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        allowed = atol if dtype == torch.float32 else _bf16_spacing_at_max(ref)
        assert float((got.float() - ref.float()).abs().max()) <= allowed


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_plan_shared_memory_matches_the_libraries(cuda, dtype):
    """The shared memory that ``stream_plan`` counts is what the kernels lay out."""
    from transkun_tpu_torch.ops import attention

    bf16 = int(dtype == torch.bfloat16)
    fwd = attention._library("attention_fwd").attention_fwd_stream_smem_bytes
    bwd = attention._library("attention_bwd").attention_bwd_stream_smem_bytes
    for sq, dh in ((89, 32), (13261, 32), (5, 16), (300, 64), (1, 8), (100, 40)):
        plan = attention.stream_plan(1, 8, sq, 1000, dh, dtype, 132)
        assert fwd(plan.warps, dh, bf16) == plan.fwd_smem
        assert bwd(plan.warps, dh, bf16, 0) == plan.rows_smem
        assert bwd(plan.warps, dh, bf16, 1) == plan.keys_smem


@pytest.mark.gpu
def test_attention_kernels_reject_what_they_do_not_take(cuda):
    from transkun_tpu_torch.ops import attention

    q, k, v, do = _attn_inputs(np.random.default_rng(0), 2, 9, 11, 16, cuda)
    o = torch.zeros_like(q)
    for fn, extra in ((attention.attention_fwd_cuda, ()), (attention.attention_bwd_cuda, (o, do))):
        with pytest.raises(TypeError):
            fn(q.double(), k.double(), v.double(), *[e.double() for e in extra], 2, 0.5)
        with pytest.raises(TypeError):  # fp32 or bf16 only
            fn(q.half(), k.half(), v.half(), *[e.half() for e in extra], 2, 0.5)
        with pytest.raises(TypeError):  # one type for all: bf16 q against fp32 k and v
            fn(q.bfloat16(), k, v, *extra, 2, 0.5)
        with pytest.raises(TypeError):  # fp32 q against a bf16 v
            fn(q, k, v.bfloat16(), *extra, 2, 0.5)
        # bf16 throughout is taken, and comes back as bf16
        out = fn(q.bfloat16(), k.bfloat16(), v.bfloat16(), *[e.bfloat16() for e in extra], 2, 0.5)
        assert all(t.dtype == torch.bfloat16 for t in (out if isinstance(out, tuple) else (out,)))
        with pytest.raises(ValueError):  # non-contiguous
            fn(q, k.transpose(0, 1).contiguous().transpose(0, 1), v, *extra, 2, 0.5)
        with pytest.raises(ValueError):  # k and v disagree
            fn(q, k, v[:, :-1].contiguous(), *extra, 2, 0.5)
        with pytest.raises(ValueError):  # heads do not divide the width
            fn(q, k, v, *extra, 3, 0.5)
        with pytest.raises(ValueError):  # another device
            fn(q, k.cpu(), v, *extra, 2, 0.5)
        with pytest.raises(ValueError):  # no variant: a long sequence at a head_dim above 64
            long = torch.zeros(1, 30000, 160, device=cuda)
            fn(long, long, long, *[long for _ in extra], 2, 0.5)
        with pytest.raises(ValueError):  # the streaming kernels take head_dim <= 64
            wide = torch.zeros(1, 20, 160, device=cuda)
            fn(wide, wide, wide, *[wide for _ in extra], 2, 0.5, variant="stream")
        with pytest.raises(ValueError):  # the tensor-core kernel, forced past its registers
            long = torch.zeros(1, 200, 16, device=cuda)
            fn(long, long, long, *[long for _ in extra], 2, 0.5, variant="mma")
    with pytest.raises(TypeError):  # a bf16 cotangent against fp32 tensors
        attention.attention_bwd_cuda(q, k, v, o, do.bfloat16(), 2, 0.5)
    with pytest.raises(ValueError):  # do shaped like k, not like q
        attention.attention_bwd_cuda(q, k, v, o, torch.zeros_like(k), 2, 0.5)


def _mlp_inputs(rng, m, d, hidden, dev, dtype=torch.float32):
    arrays = [
        rng.normal(size=(m, d)), rng.normal(size=(d, hidden)) / np.sqrt(d),
        rng.normal(size=hidden) * 0.1, rng.normal(size=(hidden, d)) / np.sqrt(hidden),
        rng.normal(size=d) * 0.1,
    ]
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype) for a in arrays]


def _bf16_spacing_at_max(x):
    """The bf16 spacing at the largest |value| of ``x``."""
    import math

    return 2.0 ** (math.frexp(float(x.float().abs().max()))[1] - 8)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,hidden", [(13261, 256, 1024), (1000, 128, 192), (1, 256, 64)])
def test_mlp_kernel_equals_plain(cuda, m, d, hidden):
    """Within 2e-5 of the plain version (fp32 sums in another order), and
    the five gradients within 1e-5 of autograd of the plain version.  The
    weights are leaves in ``nn.Linear``'s [out, in] layout and go in as
    transposed views, as ``FFNResBlock`` passes them."""
    from transkun_tpu_torch.ops import mlp

    x, w1, b1, w2, b2 = _mlp_inputs(np.random.default_rng(m), m, d, hidden, cuda)
    co = torch.from_numpy(
        np.random.default_rng(m + 1).normal(size=(m, d)).astype(np.float32)).to(cuda)

    def leaves():
        return [a.clone().requires_grad_() for a in (x, w1.t().contiguous(), b1, w2.t().contiguous(), b2)]

    got, want = leaves(), leaves()
    before = mlp.launches
    out = mlp.mlp(got[0], got[1].t(), got[2], got[3].t(), got[4])
    (out * co).sum().backward()
    ref = mlp.mlp_plain(want[0], want[1].t(), want[2], want[3].t(), want[4])
    (ref * co).sum().backward()
    torch.cuda.synchronize()
    assert mlp.launches == before + 1
    assert float((out.detach() - ref.detach()).abs().max()) <= 2e-5
    for g, w in zip(got, want):
        assert g.grad.shape == w.grad.shape
        assert float((g.grad - w.grad).abs().max()) <= 1e-5 * max(1.0, float(w.grad.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,hidden", [(13261, 256, 1024), (1000, 128, 192), (1000, 256, 64),
                                        (113, 128, 1024), (1, 256, 64)])
def test_mlp_kernel_both_types_and_layouts(cuda, m, d, hidden, dtype):
    """Row-major [in, out] weights, ``nn.Linear``'s layout and one of each:
    the same bits.  fp32 within 2e-5 of the plain version.  bf16 within one
    bf16 spacing of the largest output of the same function in fp64, and
    within two of the plain version, which rounds h and its sum with b1 to
    bf16 before the GELU where the kernel keeps fp32 until g."""
    from transkun_tpu_torch.ops import mlp

    x, w1, b1, w2, b2 = _mlp_inputs(np.random.default_rng(m + d), m, d, hidden, cuda, dtype)
    w1t, w2t = w1.t().contiguous().t(), w2.t().contiguous().t()
    before = mlp.launches
    got = mlp.mlp_fwd_cuda(x, w1, b1, w2, b2)
    others = [mlp.mlp_fwd_cuda(x, a, b1, b, b2) for a, b in ((w1t, w2t), (w1t, w2), (w1, w2t))]
    torch.cuda.synchronize()
    assert mlp.launches == before + 4
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert all(torch.equal(got, o) for o in others)
    want = mlp.mlp_plain(x, w1, b1, w2, b2)
    exact = (torch.nn.functional.gelu(x.double() @ w1.double() + b1.double())
             @ w2.double() + b2.double())
    err = float((got.float() - want.float()).abs().max())
    err_exact = float((got.double() - exact).abs().max())
    if dtype == torch.float32:
        assert err <= 2e-5 and err_exact <= 2e-5
    else:
        spacing = _bf16_spacing_at_max(want)
        assert err <= 2 * spacing and err_exact <= spacing


@pytest.mark.gpu
def test_mlp_bf16_through_autograd(cuda):
    """``mlp`` at bf16 over leading dimensions: one launch, a bf16 result,
    and the gradients of the plain version recomputed at bf16."""
    from transkun_tpu_torch.ops import mlp

    ops = _mlp_inputs(np.random.default_rng(3), 4 * 37, 128, 256, cuda, torch.bfloat16)
    got = [a.clone().requires_grad_() for a in ops]
    want = [a.clone().requires_grad_() for a in ops]
    before = mlp.launches
    out = mlp.mlp(got[0].view(4, 37, 128), *got[1:])
    out.float().sum().backward()
    mlp.mlp_plain(*want).float().sum().backward()
    torch.cuda.synchronize()
    assert mlp.launches == before + 1 and out.shape == (4, 37, 128) and out.dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert g.grad.dtype == torch.bfloat16 and torch.equal(g.grad, w.grad)


@pytest.mark.gpu
def test_mlp_kernel_rejects_what_it_does_not_take(cuda):
    from transkun_tpu_torch.ops import mlp

    x, w1, b1, w2, b2 = _mlp_inputs(np.random.default_rng(0), 40, 128, 128, cuda)
    with pytest.raises(TypeError):
        mlp.mlp_fwd_cuda(x.double(), w1.double(), b1.double(), w2.double(), b2.double())
    with pytest.raises(TypeError):  # one type for all: bf16 x against fp32 weights
        mlp.mlp_fwd_cuda(x.bfloat16(), w1, b1, w2, b2)
    with pytest.raises(TypeError):  # an fp32 bias among bf16 tensors
        mlp.mlp_fwd_cuda(x.bfloat16(), w1.bfloat16(), b1, w2.bfloat16(), b2.bfloat16())
    with pytest.raises(ValueError):  # a transposed view of the wrong shape
        mlp.mlp_fwd_cuda(x, w2.t()[:, :64], b1, w2, b2)
    with pytest.raises(ValueError):  # neither row-major nor the transposed view of row-major
        mlp.mlp_fwd_cuda(x, torch.zeros(128, 256, device=cuda)[:, ::2], b1, w2, b2)
    with pytest.raises(ValueError):  # widths the kernel has no instance for
        mlp.mlp_fwd_cuda(x[:, :96].contiguous(), w1[:96].contiguous(), b1,
                         w2[:, :96].contiguous(), b2[:96].contiguous())
    with pytest.raises(ValueError):  # hidden not a multiple of 64
        mlp.mlp_fwd_cuda(x, w1[:, :100].contiguous(), b1[:100].contiguous(),
                         w2[:100].contiguous(), b2)
    with pytest.raises(ValueError):  # misaligned bias
        mlp.mlp_fwd_cuda(x, w1, torch.zeros(132, device=cuda)[1:129], w2, b2)
    with pytest.raises(ValueError):  # another device
        mlp.mlp_fwd_cuda(x, w1.cpu(), b1, w2, b2)
    with pytest.raises(ValueError):  # no rows
        mlp.mlp_fwd_cuda(x[:0], w1, b1, w2, b2)


# -- row softmax ----------------------------------------------------------------

SOFTMAX_SHAPES = [  # rows, columns
    (106088, 149),  # flagship F-attention logits, one segment
    (106088, 89),  # flagship T-attention logits
    (1003, 1), (1003, 9), (1003, 33), (1003, 149),  # ragged: last block part full
    (5, 149), (8, 256),  # fewer rows than a block; the widest row the registers hold
    (1003, 300),  # wider than the registers hold: the re-reading kernel
]


def _assert_softmax_close(got, want, atol, extra=0.0):
    """fp32: ``atol`` absolute.  bf16: one bf16 unit in the last place of the
    plain result (|want| = m * 2**e, m in [0.5, 1): the spacing is
    2**(e - 8)), plus ``extra``."""
    assert got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        assert float(diff.max()) <= atol
    else:
        exponent = torch.frexp(want.float()).exponent
        ulp = torch.ldexp(torch.ones_like(diff), (exponent - 8).clamp(min=-133))
        assert bool((diff <= ulp + extra).all()), float((diff - ulp).max())


def _past_boundary(x, offset):
    """The same values in a tensor whose first value lies ``offset`` values
    past a 16-byte boundary (torch allocations start on one)."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = buf[offset : offset + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == (offset * x.element_size()) % 16 and view.is_contiguous()
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", SOFTMAX_SHAPES)
def test_softmax_kernels_equal_plain(cuda, r, c, dtype, offset):
    """Forward within 1e-6 of the plain version, backward within 1e-6 times
    the largest cotangent (dl is linear in do; the sums run in another
    order).  The backward's ``do - delta`` cancels, so at bf16 it gets that
    fp32 bound besides the one bf16 unit.  With the tensors on a 16-byte
    boundary and 1 and 4 values past one, and (1003 rows) a last block that
    is part full."""
    gen = torch.Generator(device=cuda).manual_seed(r + c)
    l = _past_boundary((torch.randn(r, c, generator=gen, device=cuda) * 3).to(dtype), offset)
    do = _past_boundary(torch.randn(r, c, generator=gen, device=cuda).to(dtype), offset)
    f0, b0 = softmax.fwd_launches, softmax.bwd_launches
    p = softmax.softmax_fwd_cuda(l)
    dl = softmax.softmax_bwd_cuda(l, do)
    torch.cuda.synchronize()
    assert (softmax.fwd_launches, softmax.bwd_launches) == (f0 + 1, b0 + 1)
    _assert_softmax_close(p, softmax.softmax_plain(l), 1e-6)
    bwd_atol = 1e-6 * max(1.0, float(do.float().abs().max()))
    _assert_softmax_close(dl, softmax.softmax_bwd_plain(l, do), bwd_atol, extra=bwd_atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_last_autograd_runs_the_kernels(cuda, dtype, monkeypatch):
    """``softmax_last`` over an N-d, non-contiguous tensor with the flag
    set: one forward and one backward launch, the cotangent that autograd
    gives ``torch.softmax``; with the flag unset, no launch."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    l = (torch.randn(3, 37, 4, 61, generator=gen, device=cuda) * 2).to(dtype).transpose(1, 2)
    do = torch.randn(3, 4, 37, 61, generator=gen, device=cuda).to(dtype)
    assert not l.is_contiguous()
    monkeypatch.delenv("TRANSKUN_TPU_NO_PALLAS", raising=False)
    monkeypatch.delenv("TRANSKUN_TPU_FUSED_SOFTMAX", raising=False)
    f0, b0 = softmax.fwd_launches, softmax.bwd_launches
    ref_in = l.detach().clone().requires_grad_()
    ref = softmax.softmax_last(ref_in)  # torch.softmax
    ref.backward(do)
    assert (softmax.fwd_launches, softmax.bwd_launches) == (f0, b0)
    monkeypatch.setenv("TRANSKUN_TPU_FUSED_SOFTMAX", "1")
    x = l.detach().clone().requires_grad_()
    out = softmax.softmax_last(x)
    out.backward(do)
    torch.cuda.synchronize()
    assert (softmax.fwd_launches, softmax.bwd_launches) == (f0 + 1, b0 + 1)
    assert out.shape == l.shape and out.dtype == dtype and x.grad.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7  # bf16: a unit at magnitude 1
    assert float((out.detach().float() - ref.detach().float()).abs().max()) <= tol
    assert float((x.grad.float() - ref_in.grad.float()).abs().max()) <= tol


@pytest.mark.gpu
def test_softmax_kernels_reject_what_they_do_not_take(cuda):
    l = torch.zeros(8, 5, device=cuda)
    with pytest.raises(TypeError):
        softmax.softmax_fwd_cuda(l.double())
    with pytest.raises(TypeError):  # do has the dtype of l
        softmax.softmax_bwd_cuda(l, l.bfloat16())
    with pytest.raises(TypeError):  # and its shape
        softmax.softmax_bwd_cuda(l, l[:4])
    with pytest.raises(ValueError):  # non-contiguous
        softmax.softmax_fwd_cuda(l.t())
    with pytest.raises(ValueError):  # not [R, C]
        softmax.softmax_fwd_cuda(l[None])
    with pytest.raises(ValueError):  # no rows
        softmax.softmax_fwd_cuda(l[:0])
    with pytest.raises(ValueError):  # another device
        softmax.softmax_bwd_cuda(l, l.cpu())


def _walk_inputs(rng, n, t, p=90, n_edge=2):
    """A group's chain inputs on the CPU: Viterbi tables of random scores
    (shifted down, so that a walk has a few events and many skips, as a
    decode does), random presence bits."""
    ptrs, diags = [], []
    for _ in range(n):
        score = torch.from_numpy((rng.normal(size=(t, t, p)) - 2.5).astype(np.float32))
        noise = torch.from_numpy((rng.normal(size=(t - 1, p)) * 0.5).astype(np.float32))
        ptr, diag = semicrf.viterbi_backward_tables(score, noise)
        ptrs.append(ptr)
        diags.append(diag)
    bpres = torch.from_numpy(rng.random((n, p, t, n_edge)) < 0.5)
    return torch.stack(ptrs).int(), torch.stack(diags), bpres


def _long_walk_inputs(rng, n, t, p=90, n_edge=2):
    """Chain inputs at a t too long for Viterbi tables of real scores: each
    position skips, or ends an interval up to 40 positions on; singletons
    at 2% of the positions."""
    j = np.arange(t - 1)[None, :, None]
    sel = rng.integers(0, 40, size=(n, t - 1, p)) % np.maximum(t - 1 - j, 1)
    ptr = np.where(rng.random((n, t - 1, p)) < 0.7, -1, sel).astype(np.int32)
    diag = rng.random((n, t, p)) < 0.02
    bpres = rng.random((n, p, t, n_edge)) < 0.5
    return torch.from_numpy(ptr), torch.from_numpy(diag), torch.from_numpy(bpres)


def _walk_on_sentinel(args, geometry):
    """``walk_group`` (the dispatcher, which takes CUDA tensors to the
    kernel) with begins and ends on memory that held -7 in every slot: the
    caching allocator hands the outputs the blocks of two freed tensors of
    their size, so a slot the kernel does not write shows."""
    n, _, p = args[1].shape
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sentinel = [torch.full((n, p, geometry[0]), -7, dtype=torch.int32, device=args[0].device)
                for _ in range(2)]
    where = {a.data_ptr() for a in sentinel}
    del sentinel
    got = walk.walk_group(*args, *geometry)
    assert {got[0].data_ptr(), got[1].data_ptr()} == where
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["chain", "forced_starts", "overflow", "onset_bound", "one_segment",
                                  "ragged_tile", "odd_offsets", "global_events", "unstaged"])
def test_walk_kernel_equals_plain(cuda, case):
    """The walk kernel against ``walk_group_plain`` on the same inputs, every
    output equal, two launches the same bits, begins and ends written in
    every slot (each launch on memory that held a sentinel), through the
    dispatcher ``walk_group``: a chain of 4 segments from zero starts,
    random forced starts, a k_max of 2 that overflows, an onset bound, a
    group of one segment at another t; P = 89, whose last tile holds one
    track; P = 45 with diag at an odd address, so that the tracks' diag
    bytes start at every offset in a word; a k_max of 16384, whose buffer
    does not fit (events stored to global memory); and a segment of 30000
    positions, whose columns do not fit (the walk reads global memory; the
    plain version on the card)."""
    rng = np.random.default_rng(11)
    n, t, p, k_max, onset_bound = 4, 123, 90, 128, -1
    if case == "one_segment":
        n, t = 1, 61
    p = {"ragged_tile": 89, "odd_offsets": 45}.get(case, p)
    k_max = {"overflow": 2, "global_events": 16384}.get(case, k_max)
    if case == "unstaged":
        n, t = 1, 30000
        ptr, diag, bpres = _long_walk_inputs(rng, n, t)
    else:
        ptr, diag, bpres = _walk_inputs(rng, n, t, p)
    start = torch.zeros(p, dtype=torch.int32)
    if case in ("forced_starts", "onset_bound"):
        start = torch.from_numpy(rng.integers(0, t, size=p).astype(np.int32))
    if case == "onset_bound":
        onset_bound = t // 2
    geometry = (k_max, t - 2, t // 3, onset_bound)
    plan = walk.launch_plan(n, t, p, k_max, bpres.shape[-1])
    assert (plan.slots > 0, plan.buffered) == {
        "global_events": (True, False), "unstaged": (False, True)}.get(case, (True, True))
    assert walk._library().decode_walk_smem_bytes(
        t, plan.tile, plan.slots, plan.buffered, k_max, bpres.shape[-1]) == plan.smem
    args = [a.to(cuda) for a in (ptr, diag, bpres, start)]
    if case == "odd_offsets":
        odd = torch.empty(diag.numel() + 1, dtype=torch.bool, device=cuda)[1:].view(diag.shape)
        args[1] = odd.copy_(args[1])
        assert args[1].is_contiguous() and args[1].data_ptr() % 2 == 1
    on_card = case in ("global_events", "unstaged")  # the plain version's one-hot is large
    want = walk.walk_group_plain(*(args if on_card else (ptr, diag, bpres, start)), *geometry)
    before = walk.launches
    got, again = (_walk_on_sentinel(args, geometry) for _ in range(2))
    torch.cuda.synchronize()
    assert walk.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, a) and torch.equal(g.cpu(), w.cpu())
    # the long segment's tracks emit more events than k_max: overflow on that route too
    assert bool(want[3].any()) == (case in ("overflow", "unstaged"))
    assert int(want[2].sum()) > 0


@pytest.mark.gpu
def test_walk_kernel_rejects_what_it_does_not_take(cuda):
    ptr, diag, bpres = (a.to(cuda) for a in _walk_inputs(np.random.default_rng(0), 2, 20))
    start = torch.zeros(90, dtype=torch.int32, device=cuda)
    geometry = (16, 18, 9)
    with pytest.raises(TypeError):  # int32 pointers
        walk.walk_group(ptr.long(), diag, bpres, start, *geometry)
    with pytest.raises(TypeError):  # bool tables
        walk.walk_group(ptr, diag.int(), bpres, start, *geometry)
    with pytest.raises(ValueError):  # non-contiguous
        walk.walk_group(ptr.transpose(0, 1).contiguous().transpose(0, 1), diag, bpres, start, *geometry)
    with pytest.raises(ValueError):  # mismatched shapes
        walk.walk_group(ptr[:, :-1], diag, bpres, start, *geometry)
    with pytest.raises(ValueError):  # another device
        walk.walk_group(ptr, diag, bpres, start.cpu(), *geometry)


@pytest.mark.gpu
def test_two_rank_step_on_one_card_keeps_the_ranks_equal(cuda, tmp_path):
    """Two gloo ranks on ``cuda:0`` take two data-parallel steps: each
    launches the alpha and beta kernels once a step, and the ranks'
    parameters are equal bit for bit after each step."""
    import _torch_dist_ranks as ranks

    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    ranks.run_pair("v2_card", str(tmp_path / "none.pt"), outs)
    got = [torch.load(p, weights_only=False) for p in outs]
    for step in range(ranks.STEPS):
        a, b = got[0]["params"][step], got[1]["params"][step]
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert got[0]["launches"] == got[1]["launches"] == (ranks.STEPS, ranks.STEPS)
    assert not torch.equal(got[0]["params"][0]["scorer.map.0.weight"],
                           got[0]["params"][1]["scorer.map.0.weight"])


@pytest.mark.gpu
def test_crf_example_on_the_card_equals_plain(cuda):
    """``crf_minimal_example`` on the card: ``logProb`` (the alpha and beta
    kernels) within 1e-5 relative of ``eval_path - log_z_slow``, and both
    decodes (the Viterbi kernel) equal to the plain tables' walk."""
    from transkun_tpu_torch import crf_minimal_example

    before = (viterbi.launches, logz.alpha_launches, logz.beta_launches)
    out = crf_minimal_example.main(["--device", "cuda"])
    torch.cuda.synchronize()
    assert (viterbi.launches - before[0], logz.alpha_launches - before[1],
            logz.beta_launches - before[2]) == (2, 1, 1)
    score, noise = out["score"], out["noise_score"]
    want = semicrf.eval_path(out["intervals"], score, noise) - semicrf.log_z_slow(score, noise)
    torch.testing.assert_close(out["log_prob"], want, rtol=1e-5, atol=0)
    s_t, noise_pad, gate = semicrf.decode_layout(score, noise)
    t, n = score.shape[0], score.shape[2]
    ptr = viterbi.viterbi_backward_tables_plain(s_t, noise_pad, gate)[: t - 1, :n].cpu().numpy()
    diag = (gate[:t, :n] > 0).cpu().numpy()
    assert out["decoded"] == semicrf.backtrack_backward(ptr, diag, None)
    assert out["decoded_forced"] == semicrf.backtrack_backward(ptr, diag, [100] * n)


@pytest.mark.gpu
def test_dequantize_int16_on_the_card_equals_np_divide(cuda):
    """The training link's division by 32767 on the card: every int16 value
    equal to the host slicer's ``np.divide`` bit for bit (a division by a
    CPU scalar there is a reciprocal product, one bit off on ~2%)."""
    from transkun_tpu_torch.data.device_dataset import dequantize_int16

    v = np.arange(-32768, 32768).astype(np.int16)
    got = dequantize_int16(torch.from_numpy(v).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.divide(v, 32767, dtype=np.float32).view(np.int32))
