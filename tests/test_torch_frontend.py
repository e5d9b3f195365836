"""The port's DSP frontend against ``transkun_tpu.ops.frontend``: framing
exact, the band-limited GEMM log-mel within 1e-5 (fp32 sums in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transkun_tpu.ops import frontend as jf
from transkun_tpu_torch.ops import frontend as tf


@pytest.mark.parametrize("n,hop,win", [(1000, 64, 256), (1001, 100, 256), (63, 64, 256)])
def test_make_frame_exact(rng, n, hop, win):
    x = rng.normal(size=(2, 1, n)).astype(np.float32)
    want = np.asarray(jf.make_frame(jnp.asarray(x), hop, win))
    got = tf.make_frame(torch.from_numpy(x), hop, win).numpy()
    assert got.shape == want.shape == (2, 1, tf.num_frames(n, hop), win)
    np.testing.assert_array_equal(got, want)


def test_host_constants_equal():
    fb_j = jf.melscale_fbanks(129, 30, 1900, 32, 4000)
    fb_t = tf.melscale_fbanks(129, 30, 1900, 32, 4000)
    np.testing.assert_array_equal(fb_t, fb_j)
    for a, b in zip(tf.dft_mel_matrices(256, fb_t), jf.dft_mel_matrices(256, fb_j)):
        np.testing.assert_array_equal(a, b)
    init_t, init_j = tf.gaussian_windows_init(5), jf.gaussian_windows_init(5)
    for k in init_j:
        np.testing.assert_array_equal(init_t[k], init_j[k])


def test_mel_spectrum_gemm_matches_jax(rng):
    win, n_mels, fs = 256, 32, 4000
    frames = rng.normal(size=(2, 2, 30, win)).astype(np.float32)
    sigma = rng.normal(size=3).astype(np.float32) * 0.3 - 1.0
    center = rng.normal(size=3).astype(np.float32)
    fb = tf.melscale_fbanks(win // 2 + 1, 30, 1900, n_mels, fs)
    cos_m, sin_m, fb_band = tf.dft_mel_matrices(win, fb)

    wins_j = jnp.concatenate(
        [jf.hann_window(win)[None], jf.gaussian_windows(jnp.asarray(sigma), jnp.asarray(center), win)]
    )
    want = np.asarray(
        jf.mel_spectrum_gemm(
            jnp.asarray(frames), wins_j, jnp.asarray(cos_m), jnp.asarray(sin_m),
            jnp.asarray(fb_band), log=True, to_mono=True,
        )
    )
    wins_t = torch.cat(
        [tf.hann_window(win)[None],
         tf.gaussian_windows(torch.from_numpy(sigma), torch.from_numpy(center), win)]
    )
    np.testing.assert_allclose(wins_t.numpy(), np.asarray(wins_j), atol=1e-6)
    got = tf.mel_spectrum_gemm(
        torch.from_numpy(frames), wins_t, torch.from_numpy(cos_m), torch.from_numpy(sin_m),
        torch.from_numpy(fb_band), log=True, to_mono=True,
    ).numpy()
    assert got.shape == want.shape == (2, 1, 30, n_mels, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
