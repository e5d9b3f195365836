"""Write the orbax checkpoint fixture that the port's reader is held to.

    JAX_PLATFORMS=cpu python scripts/make_orbax_fixture.py [--out tests/golden]

Runs the JAX package on the CPU (it is not part of the port) and writes,
under ``--out``:

- ``orbax_v2_narrow/``: JAX ``save_checkpoint`` of a narrow V2 model (the
  conf of ``tests/test_data_pipeline.py::test_checkpoint_roundtrip``), a
  train state worth resuming: params moved off their init by seeded noise,
  ``best_params`` moved by other noise (both with the scorer made
  confident, so that a piece decodes to a few notes), AdaBelief's ``mu``
  seeded and its ``nu`` seeded and positive, both optimizer counts and the
  step at ``STEP`` (past the rectification gate), a clip ring of ``STEP``
  pushes after its seed value, and the ``extra`` that the JAX trainer
  writes at a save before its first validation (``loss_tracker`` with
  ``val: []``, ``epoch``, ``run_seed``) with the ``warmstart_from`` of
  ``scripts/warmstart_ckpt.py``;
- ``orbax_v2_narrow.npz``: every array, scalar and string leaf of that
  tree, by key path (``params/params/backbone/...``,
  ``opt_state/0/mu/...``, ``extra/warmstart_from``), as JAX
  ``load_checkpoint`` returns it (an empty list has no leaf);
- ``orbax_v2_narrow.conf``: the conf, as a reference-style JSON conf file.

The seeded values lie on the bfloat16 grid (float32 with the low 16 bits
zero), so the checkpoint compresses to under 2 MB; they are float32 leaves
all the same.  Orbax stamps times and a random database id into the
files, so two runs give equal leaves but not equal bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONF = dict(f_min=30, f_max=1900, n_mels=32, hopSize=64, windowSize=256, fs=4000,
            nExtraWins=2, baseSize=8, nHead=2, nLayers=1, scoringExpansionFactor=2)
NAME = "orbax_v2_narrow"
STEP = 1000
EXTRA = {"loss_tracker": {"train": [4.5, 3.25, 2.875], "val": []}, "epoch": 3, "run_seed": 1234,
         "warmstart_from": "/some/donor"}


def flat_leaves(tree, prefix=""):
    """(key path, leaf) of every leaf, key paths joined by '/'; None leaves
    are left out."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for k, v in items:
        out += flat_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join("tests", "golden"))
    parser.add_argument("--seed", type=int, default=16)
    args = parser.parse_args(argv)

    import jax

    from transkun_tpu.models import ModelConfig, TransKun
    from transkun_tpu.train import init_train_state, make_optimizer
    from transkun_tpu.train.checkpoint import load_checkpoint, save_checkpoint

    conf = ModelConfig.from_dict(CONF)
    init = TransKun(conf).init(jax.random.PRNGKey(0), n_frames=33)
    rng = np.random.default_rng(args.seed)

    def moved(tree):
        return jax.tree.map(
            lambda a: a + np.float32(0.02) * rng.standard_normal(a.shape).astype(np.float32), tree)

    def bf16_grid(tree):
        return jax.tree.map(
            lambda a: (np.asarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32),
            tree)

    def confident(tree):
        # random weights decode near-ties everywhere: make the scorer
        # confident, as a trained one is (tests/test_torch_transcribe.py):
        # 10x its projection, a shared negative q.k offset, and the
        # diagonal bias at -8 keeps random singletons off
        m = tree["params"]["scorer"]["map"]
        e = m["kernel"].shape[1] // 2
        m["kernel"] = m["kernel"] * np.float32(10.0)
        m["bias"] = m["bias"].copy()
        m["bias"][0] += 6.0
        m["bias"][e] -= 6.0
        m["bias"][-1] = -8.0
        return tree

    init = jax.tree.map(np.array, init)
    params, best_params = (bf16_grid(confident(moved(init))) for _ in range(2))
    state = init_train_state(params, make_optimizer(params["params"]))
    # the optimizer and clip state of a run at STEP, from a generator of its
    # own (the weights stay those of the seed's first draws)
    rng = np.random.default_rng(args.seed + 1)
    belief, masked, schedule = state.opt_state
    seeded = lambda f: bf16_grid(jax.tree.map(  # noqa: E731
        lambda a: f(rng.standard_normal(a.shape)).astype(np.float32), params["params"]))
    belief = belief._replace(count=np.int32(STEP), mu=seeded(lambda x: 1e-3 * x),
                             nu=seeded(lambda x: 1e-6 * np.abs(x) + 1e-8))
    buffer = np.asarray(state.clip_state.buffer).copy()
    buffer[1:STEP + 1] = bf16_grid(rng.uniform(0.5, 5.0, STEP).astype(np.float32))
    state = state._replace(opt_state=(belief, masked, schedule._replace(count=np.int32(STEP))),
                           clip_state=state.clip_state._replace(buffer=buffer, count=np.int32(STEP + 1)),
                           step=np.int32(STEP))
    path = os.path.abspath(os.path.join(args.out, NAME))
    if os.path.exists(path):
        shutil.rmtree(path)
    save_checkpoint(path, state, best_params=best_params, extra=EXTRA)
    leaves = {k: np.asarray(v) for k, v in flat_leaves(load_checkpoint(path))}
    np.savez_compressed(path + ".npz", **leaves)
    with open(path + ".conf", "w") as f:
        json.dump({"Model": {"module": "transkun.ModelTransformer", "configClassName": "Config",
                             "config": CONF}}, f, indent=4)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(path) for n in names)
    print(f"wrote {path} ({size} bytes), {len(leaves)} leaves in {path}.npz")


if __name__ == "__main__":
    main()
