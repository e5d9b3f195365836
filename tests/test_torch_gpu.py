"""The port's CUDA kernel against its plain PyTorch version, on the card.

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from transkun_tpu_torch.ops import viterbi

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
