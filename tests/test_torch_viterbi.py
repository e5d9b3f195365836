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
