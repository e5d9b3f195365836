"""transkun_tpu_torch — the PyTorch/CUDA port of ``transkun_tpu``.

Audio in, expressive MIDI out, through the same axial-attention backbone and
neural semi-Markov CRF as the JAX package, with the Viterbi decoder as a CUDA
kernel written for Hopper (``csrc/viterbi_bwd.cu``).  The JAX package stays
the reference; module names here mirror its modules one for one.

Importing this package imports ``torch`` and never ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
