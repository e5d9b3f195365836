"""Minimal semi-CRF usage example of the port (counterpart of
``transkun/crfMinimalExample.py`` and ``transkun_tpu/crf_minimal_example.py``):
score tensors in, interval decode out.

    python -m transkun_tpu_torch.crf_minimal_example [--device cpu]

The scores are drawn from a seeded ``torch.Generator`` on the device.  On
the card ``logProb`` runs the alpha and beta kernels and ``decode`` the
Viterbi kernel; the default device is ``cuda``, and without CUDA the example
fails unless given ``--device cpu``.  ``main`` returns the scores, the
intervals and the results, for callers that drive it from Python.
"""

import argparse

import torch

from transkun_tpu_torch.ops.semicrf import NeuralSemiCRFInterval

T, N_BATCH = 200, 4
INTERVALS = [
    [(0, 2), (4, 6), (6, 6), (7, 8)],
    [(1, 2), (3, 5), (19, 19)],
    [(0, 0), (4, 7)],
    [],
]


def main(argv=None):
    parser = argparse.ArgumentParser(description="semi-CRF example (PyTorch port)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seed", default=0, type=int)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    device = torch.device(args.device)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    score = torch.randn((T, T, N_BATCH), generator=generator, device=device)
    noise_score = torch.randn((T - 1, N_BATCH), generator=generator, device=device)

    crf = NeuralSemiCRFInterval(score, noise_score)

    # log probability of a given set of non-overlapping intervals per track
    log_prob = crf.logProb(INTERVALS)
    print("logProb:", log_prob)

    # MAP decoding
    decoded = crf.decode()
    print("decoded:", decoded)

    # forced start position (used for streaming segment stitching)
    decoded_forced = crf.decode(forcedStartPos=[100] * N_BATCH)
    print("decoded from frame 100:", decoded_forced)
    return {"score": score, "noise_score": noise_score, "intervals": INTERVALS,
            "log_prob": log_prob, "decoded": decoded, "decoded_forced": decoded_forced}


if __name__ == "__main__":
    main()
