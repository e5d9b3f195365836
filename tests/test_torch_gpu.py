"""The port's eight CUDA kernels against their plain PyTorch versions, on the card;
the Viterbi and beta kernels also on tie-heavy inputs, at every cluster size
and at the cluster edges (one lane group; more lane groups than SMs).

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from transkun_tpu_torch.ops import logz, softmax, viterbi

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
    fp32 kernels on the upcast tensor bit for bit (the beta kernel at the
    bf16 launch's cluster size: the cluster splits each lane's sum, and the
    two types are planned apart); then ``log_z_padded`` gives a bf16 score
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
    assert torch.equal(v, logz.alpha_table_padded(s_b.float(), shift, spdiag))
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
    (2, 33, 21, 2, 80),  # head_dim above the tensor-core kernel's instances
]
ATTN_GENERAL = {(2, 300, 200, 2, 32), (2, 33, 21, 2, 80)}  # what the general kernels run


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
    want_variant = "general" if (b, sq, skv, h, dh) in ATTN_GENERAL else "mma"
    assert attention.kernel_variant("attention_fwd", sq, skv, dh) == want_variant
    assert attention.kernel_variant("attention_bwd", sq, skv, dh) == want_variant
    f0, b0 = attention.fwd_launches, attention.bwd_launches
    for a in (q, k, v):
        a.requires_grad_()
    o = attention.fused_attention(q, k, v, h, scale)
    o.backward(do)
    torch.cuda.synchronize()
    assert (attention.fwd_launches, attention.bwd_launches) == (f0 + 1, b0 + 1)
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
@pytest.mark.parametrize("variant", ["mma", "general"])
def test_attention_backward_twice_gives_the_same_bits(cuda, dtype, variant):
    """No output is accumulated by more than one warp and nothing goes
    through atomics: two runs are equal bit for bit, in both kernels."""
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
        with pytest.raises(ValueError):  # more shared memory than a block has
            long = torch.zeros(1, 30000, 16, device=cuda)
            fn(long, long, long, *[long for _ in extra], 2, 0.5)
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
