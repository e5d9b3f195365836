"""The ranks of ``tests/test_torch_dist.py``'s process pairs, and the data
they share with it.  Imports no JAX:

    python tests/_torch_dist_ranks.py TASK IN OUT

runs one rank of TASK under the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) over gloo:
``v2`` and ``v1`` on the CPU, ``v2_card`` with both ranks on the card
``cuda:0``.  It reads its inputs from the ``torch.save`` file IN and writes
its results to OUT.  ``run_pair`` starts both ranks and waits.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 4000
MAX_EVENTS = 8
STEPS = 2
V2_CONF = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": FS, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 1,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0, "segmentHopSizeInSecond": 1.0,
    "scoreDropoutProb": 0.0, "contextDropoutProb": 0.0, "velocityDropoutProb": 0.0,
    "refinedOFDropoutProb": 0.0,
}
V1_CONF = dict(
    f_min=30, f_max=1900, n_mels=32, hopSize=64, windowSize=256, fs=FS, nExtraWins=2,
    preConvSpec=[
        {"outputSize": 8, "hiddenSize": 8, "kernelSize": 3, "stride": (1, 2), "dropoutProb": 0.0},
        {"outputSize": 12, "hiddenSize": 12, "kernelSize": 3, "stride": (1, 2), "dropoutProb": 0.0},
    ],
    ctxSize=32, nLayersCtx=2, rnnHiddenSize=16, pitchEmbedSize=16,
    scoreDropoutProb=0.0, contextDropoutProb=0.0, velocityDropoutProb=0.0,
    refinedOFDropoutProb=0.0, segmentSizeInSecond=2.0, segmentHopSizeInSecond=1.0,
)
OPTIMIZER = dict(max_lr=1e-3, weight_decay=1e-4, n_iter=100, warmup_cutoff=0)
# an optimizer step count past the rectification gate, which holds the
# parameters still for the first steps (and with them, the ranks' bits)
OPT_COUNT = 10
# the 5-vectors each rank validates (logProb, length, nGT, nEst, nCorrect)
VAL_COUNTS = ([-1234.5678901234, 3.25, 17.0, 15.0, 11.0], [-987.654321, 2.0, 9.0, 12.0, 8.0])


def batch(step, n=4):
    """The global batch of ``step``: audio [n, FS, 1] and note lists; row 3
    (rank 1's second row) holds a trill of 12 notes on one pitch, more than
    MAX_EVENTS, so rank 1 alone would grow K."""
    from transkun_tpu_torch.data.note import Note

    rng = np.random.default_rng(100 + step)
    audio = (rng.normal(size=(n, FS, 1)) * 0.1).astype(np.float32)
    notes = [[Note(0.1, 0.4, 60, 80), Note(0.45, 0.8, 60, 70), Note(0.2, 0.9, 64, 90)],
             [Note(0.05, 0.3, 72, 50), Note(0.0, 0.6, -64, 127, hasOnset=False)],
             [Note(0.3, 0.5, 48, 100)],
             [Note(0.02 + 0.08 * i, 0.06 + 0.08 * i, 67, 60 + i) for i in range(12)]]
    return audio, notes[:n]


def run_pair(task, in_path, out_paths, timeout=240):
    """Both ranks of ``task`` (``parallel.launch_ranks``); raises with their
    output if either fails."""
    from transkun_tpu_torch.parallel import launch_ranks

    launch_ranks(lambda rank: [sys.executable, os.path.abspath(__file__), task, in_path, out_paths[rank]],
                 2, local_rank=(lambda rank: 0) if task == "v2_card" else None, cwd=REPO, timeout=timeout)


class RecordingClip:
    """A step's clip that keeps the gradients it is handed (the summed
    ones, the all-reduce's flat buffer) and those it hands on (the clipped
    ones), each as the parameters' views of a copy."""

    def __init__(self, clip, optimizer):
        self.clip, self.optimizer, self.grads, self.clipped = clip, optimizer, None, None

    def __call__(self, grads, q):
        self.grads = self.optimizer.views(grads.clone())
        out = self.clip(grads, q)
        self.clipped = self.optimizer.views(out[0].clone())
        return out

    def push(self, norm, finite):
        self.clip.push(norm, finite)


def _v2(rank, inputs):
    """STEPS data-parallel steps of the V2 model on the rank's half of each
    global batch from the optimizer's count 0, then one from OPT_COUNT (past
    the rectification gate: the parameters move); also the collectives of
    validation and label encoding."""
    import torch

    from transkun_tpu_torch.data.labels import encode_batch
    from transkun_tpu_torch.models.config import ModelConfig
    from transkun_tpu_torch.models.transkun import TransKun
    from transkun_tpu_torch.parallel import all_reduce_max
    from transkun_tpu_torch.train.optim import AdaBelief
    from transkun_tpu_torch.train.step import TrainState, make_train_step
    from transkun_tpu_torch.train.validate import AGG_KEYS, aggregate_across_processes

    group = torch.distributed.group.WORLD
    model = TransKun(ModelConfig.from_dict(V2_CONF), device="cpu")
    model.load_state_dict(inputs["state_dict"])
    state = TrainState(model, AdaBelief(model.module.named_parameters(), **OPTIMIZER))
    state.clip = RecordingClip(state.clip, state.optimizer)
    step_fn = make_train_step(model, group=group)

    def k_sync(densest):
        return int(all_reduce_max(torch.tensor(densest), group))

    out = {"metrics": [], "params": [], "mu": [], "nu": [], "clipped": [], "k": []}
    names = [n for n, _ in state.optimizer.named]
    rows = slice(2 * rank, 2 * rank + 2)
    for step in range(STEPS + 1):
        if step == STEPS:  # one more step past the rectification gate
            state.optimizer.count.fill_(OPT_COUNT)
        audio, notes = batch(step)
        labels = model.labels(notes[rows], MAX_EVENTS, k_sync=k_sync)
        out["k"].append(labels[0].shape[-1])
        m = step_fn(state, model.frames(audio[rows]), labels, None)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append({k: v.clone() for k, v in model.module.state_dict().items()})
        out["mu"].append({k: v.clone() for k, v in state.optimizer.mu.items()})
        out["nu"].append({k: v.clone() for k, v in state.optimizer.nu.items()})
        out["clipped"].append(dict(zip(names, state.clip.clipped)))
    hop = V2_CONF["hopSize"] / FS
    pitches = model.targetMIDIPitch
    mine = batch(0)[1][2 * rank: 2 * rank + 2]
    out["k_local"] = encode_batch(mine, hop, pitches, MAX_EVENTS).begins.shape[-1]
    out["k_synced"] = encode_batch(mine, hop, pitches, MAX_EVENTS, k_sync=k_sync).begins.shape[-1]
    out["aggregate"] = aggregate_across_processes(dict(zip(AGG_KEYS, VAL_COUNTS[rank])))
    return out


def _v2_card(rank, inputs):
    """STEPS data-parallel steps of the tiny V2 model, both ranks on the
    card: the parameters after each step and the kernels' launches."""
    import torch

    from transkun_tpu_torch.models.config import ModelConfig
    from transkun_tpu_torch.models.transkun import TransKun
    from transkun_tpu_torch.ops import logz
    from transkun_tpu_torch.train.optim import AdaBelief
    from transkun_tpu_torch.train.step import TrainState, make_train_step

    model = TransKun(ModelConfig.from_dict(V2_CONF), device="cuda:0", seed=0)
    state = TrainState(model, AdaBelief(model.module.named_parameters(), **OPTIMIZER))
    state.optimizer.count.fill_(OPT_COUNT)
    step_fn = make_train_step(model, group=torch.distributed.group.WORLD)
    before = (logz.alpha_launches, logz.beta_launches)
    params = []
    for step in range(STEPS):
        audio, notes = batch(step)
        rows = slice(2 * rank, 2 * rank + 2)
        step_fn(state, model.frames(audio[rows]), model.labels(notes[rows], 16), None)
        params.append({k: v.cpu() for k, v in model.module.state_dict().items()})
    launches = (logz.alpha_launches - before[0], logz.beta_launches - before[1])
    return {"params": params, "launches": launches}


def _v1(rank, inputs):
    """One data-parallel step of the V1 model on the rank's half of the
    global batch: the BatchNorm statistics summed over the ranks, and the
    summed gradients the clip was handed."""
    import torch

    from transkun_tpu_torch.models.ablation import AblationConfig, TransKunAblation
    from transkun_tpu_torch.train.optim import AdaBelief
    from transkun_tpu_torch.train.step import TrainState, make_train_step

    model = TransKunAblation(AblationConfig.from_dict(V1_CONF), device="cpu", seed=0)
    state = TrainState(model, AdaBelief(model.module.named_parameters(), **OPTIMIZER))
    state.optimizer.count.fill_(OPT_COUNT)
    state.clip = RecordingClip(state.clip, state.optimizer)
    step_fn = make_train_step(model, group=torch.distributed.group.WORLD)
    audio, notes = batch(0)
    rows = slice(2 * rank, 2 * rank + 2)
    m = step_fn(state, model.frames(audio[rows]), model.labels(notes[rows], 16), None)
    names = [n for n, _ in state.optimizer.named]
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state_dict": {k: v.clone() for k, v in model.module.state_dict().items()},
            "grads": dict(zip(names, state.clip.grads))}


def main(task, in_path, out_path):
    sys.path.insert(0, REPO)
    import torch

    from transkun_tpu_torch.parallel import init_distributed, process_info

    torch.set_num_threads(1)
    on_card = task == "v2_card"
    assert init_distributed("cuda" if on_card else "cpu", backend="gloo")
    rank, world = process_info()
    assert world == 2 and torch.distributed.get_backend() == "gloo"
    inputs = torch.load(in_path, weights_only=False) if os.path.exists(in_path) else {}
    try:
        result = {"v2": _v2, "v1": _v1, "v2_card": _v2_card}[task](rank, inputs)
    finally:
        torch.distributed.destroy_process_group()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "transkun_tpu")]
    assert not bad, bad
    torch.save(result, out_path)


if __name__ == "__main__":
    main(*sys.argv[1:4])
