"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from transkun_tpu_torch.ops import logz, viterbi

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
def test_kernel_rejects_what_it_does_not_take(cuda):
    s_t, noise, diag = _decode_inputs(np.random.default_rng(0), 20, 128, cuda)
    with pytest.raises(TypeError):
        viterbi.viterbi_backward_tables_padded(s_t.double(), noise, diag)
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
def test_logz_kernels_reject_what_they_do_not_take(cuda):
    s, shift, noise, spdiag = _table_inputs(np.random.default_rng(0), 20, 128, 128, cuda)
    for fn, rows in ((logz.alpha_table_padded, shift), (logz.beta_table_padded, noise)):
        with pytest.raises(TypeError):
            fn(s.double(), rows, spdiag)
        with pytest.raises(ValueError):  # lanes not a multiple of 32
            fn(s[:, :, :100].contiguous(), rows[:, :100].contiguous(), spdiag[:, :100].contiguous())
        with pytest.raises(ValueError):  # non-contiguous
            fn(s.transpose(0, 1), rows, spdiag)
        with pytest.raises(ValueError):  # wrong shape
            fn(s, rows[:-1], spdiag)
        with pytest.raises(ValueError):  # another device
            fn(s, rows.cpu(), spdiag)
