"""transkun_tpu_torch — the PyTorch/CUDA port of ``transkun_tpu``.

Audio in, expressive MIDI out, through the same axial-attention backbone and
neural semi-Markov CRF as the JAX package, with its TPU kernels rewritten as
CUDA kernels for Hopper (``csrc/``: the Viterbi decoder, the semi-CRF alpha
and beta tables, and the opt-in fused attention and MLP).  The JAX package
stays the reference; module names here mirror its modules one for one.

Importing this package imports ``torch`` and never ``jax``, ``flax`` or any
module of ``transkun_tpu``.
"""

__version__ = "0.1.0"
