"""The check that no module of JAX or of the JAX package is loaded: whole
top-level names, so the port (``transkun_tpu_torch``) passes."""

import os
import subprocess
import sys

from benchlib import env
from bp_tiny import BENCH, ROOT


def test_whole_top_level_names():
    found = env.loaded_forbidden(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "orbax.checkpoint",
                                  "transkun_tpu", "transkun_tpu.models", "transkun_tpu_torch",
                                  "transkun_tpu_torch.models.transkun", "jaxtyping", "flaxen", "numpy"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "orbax.checkpoint",
                     "transkun_tpu", "transkun_tpu.models"]


def test_harness_and_program_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from benchlib import env, manifest, runner, transcription, training, trace, weights, synth\n"
        "from reference import v2, train, lowp\n"
        "import transkun_tpu_torch.models.transkun\n"
        "import transkun_tpu_torch.cli.train, transkun_tpu_torch.train.step\n"
        "for d in ('transcribe_many', 'train_cli'):\n"
        "    manifest.load_module('drivers', d)\n"
        "print(env.loaded_forbidden())\n" % (ROOT, BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_the_program(tmp_path):
    """A checkout of BENCHMARK.json and bench_port/ alone exits with an
    error and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "v2-pieces-fp32", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
