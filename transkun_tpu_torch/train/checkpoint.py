"""Training checkpoints: one ``torch.save`` file with the latest and best
weights, the optimizer and clip state, the step and extra run state.

Port of ``transkun_tpu/train/checkpoint.py`` (orbax there).  The weights sit
under the reference key names ``state_dict`` and ``best_state_dict``, so
``utils.convert.load_reference_checkpoint`` and the port's transcribe
``--weight`` read a training checkpoint as it is.

It also reads the JAX package's orbax checkpoint directories:
``load_orbax_checkpoint`` is JAX ``load_checkpoint(path, to_host=True)``
(the same crash-recovery order, the same tree of numpy arrays, ints and
strings) through the port's own reader (``utils/orbax_read.py``), and
``load_params`` is JAX ``load_params``: a directory's best (or latest)
flax params as the port's state_dict, or a ``.pt`` file's weights.

Crash-safe overwrite: the new file is written to ``path + ".new"`` and
swapped in with renames, so at every instant ``path``, ``path + ".new"``
(complete, mid-swap) or ``path + ".old"`` (the previous save) holds a
complete checkpoint.  ``load_checkpoint`` tries them in the order ``.new``,
``path``, ``.old``: a ``.new`` exists only when a save stopped before its
swap finished, and then it is the newest; an incomplete one fails to load
and the next is tried.  ``save_checkpoint`` never renames, removes or
writes into a directory: where one stands at any of the three, it raises
before it writes.

Continuing a JAX run: ``resolve_checkpoint`` decides what a trainer given
``saved_filename`` resumes from and where it saves.  A JAX checkpoint
directory there is read (``load_orbax_checkpoint``) and never written; the
port then saves beside it, to ``saved_filename + ".pt"``, which a later
restart prefers.  ``restore_train_state_from_orbax`` is the JAX trainer's
resume (``transkun_tpu/cli/train.py:191-211``) into the port's state:
params, the AdaBelief moments and count, the clip ring, the step, the best
params and ``extra``, bit for bit.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils.convert import load_reference_checkpoint, state_dict_from_flax
from ..utils.orbax_read import OrbaxCheckpoint
from .step import TrainState


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, state: TrainState, best_state_dict=None, extra: Optional[Dict] = None) -> None:
    """Write the train state and the best weights to ``path``, crash-safe."""
    path = os.path.abspath(path)
    new_path, old_path = path + ".new", path + ".old"
    for p in (path, new_path, old_path):
        if os.path.isdir(p):
            raise IsADirectoryError(f"{p} is a directory (a JAX checkpoint?); a checkpoint file "
                                    f"is not written over it")
    ckpt = {
        "state_dict": _cpu(state.model.module.state_dict()),
        "optimizer": _cpu(state.optimizer.state_dict()),
        "clip_buffer": _cpu(state.clip.buffer),
        "clip_count": _cpu(state.clip.count),
        "step": int(state.step),
        "extra": dict(extra or {}),
    }
    if best_state_dict is not None:
        ckpt["best_state_dict"] = _cpu(best_state_dict)
    torch.save(ckpt, new_path)
    if os.path.exists(old_path):
        os.remove(old_path)
    if os.path.exists(path):
        os.rename(path, old_path)
    os.rename(new_path, path)
    if os.path.exists(old_path):
        os.remove(old_path)


def checkpoint_exists(path: str) -> bool:
    """True if ``path`` or one of its crash-recovery siblings exists."""
    path = os.path.abspath(path)
    return any(os.path.isfile(p) for p in (path, path + ".new", path + ".old"))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The newest complete checkpoint among ``.new``, ``path``, ``.old``,
    with every tensor on the CPU."""
    path = os.path.abspath(path)
    existing = [p for p in (path + ".new", path, path + ".old") if os.path.isfile(p)]
    if not existing:
        raise FileNotFoundError(f"Checkpoint at {path} not found.")
    last_err = None
    for cand in existing:
        try:
            return torch.load(cand, map_location="cpu", weights_only=False)
        except (EOFError, RuntimeError, pickle.UnpicklingError, zipfile.BadZipFile) as e:
            last_err = e
            print(f"checkpoint fallback: {cand} unreadable ({e})")
    raise last_err


def merge_params_tolerant(target: Dict[str, Any], source: Dict[str, Any]) -> Dict[str, Any]:
    """``target`` (a state_dict) with every entry that ``source`` holds
    under the same key at the same shape taken from ``source``, and every
    other entry of ``target`` kept: the reference's tolerant partial restore
    (``TrainUtil.py:58-66``; JAX: ``train/checkpoint.py:136-153``).  Keys of
    ``source`` that ``target`` lacks are dropped."""
    return {k: source[k] if k in source and tuple(source[k].shape) == tuple(v.shape) else v
            for k, v in target.items()}


def restore_train_state(state: TrainState, ckpt: Dict[str, Any]) -> None:
    """Load weights, optimizer, clip state and step of ``ckpt`` into
    ``state``."""
    state.model.module.load_state_dict(ckpt["state_dict"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.clip.load(ckpt["clip_buffer"], ckpt["clip_count"])
    state.step = int(ckpt["step"])


def load_orbax_checkpoint(path: str, prefer: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The tree of the JAX package's orbax checkpoint at ``path``, every
    leaf on the host, as JAX ``load_checkpoint(path, to_host=True)``
    returns it.

    Candidates are tried in JAX's crash-recovery order, ``path.new``,
    ``path``, ``path.old``: a readable ``.new`` is the newest state; an
    unreadable ``.new`` or ``.old`` prints the ``checkpoint fallback:`` line
    and the next is tried.  ``prefer``: top-level keys in order of
    preference; only the first one a candidate holds is decoded, and the
    tree has only that key."""
    path = os.path.abspath(path.rstrip("/"))
    existing = [p for p in (path + ".new", path, path + ".old") if os.path.isdir(p)]
    if not existing:
        raise FileNotFoundError(f"Checkpoint at {path} not found.")
    last_err = None
    for cand in existing:
        try:
            ckpt = OrbaxCheckpoint(cand)
            if prefer is None:
                return ckpt.read()
            held = ckpt.top_level_keys()
            key = next((k for k in prefer if k in held), None)
            if key is None:
                raise KeyError(f"{cand} holds none of {list(prefer)} (it holds {held})")
            return ckpt.read((key,))
        except (OSError, ValueError, KeyError) as e:
            last_err = e
            if cand != path:
                print(f"checkpoint fallback: {cand} unreadable ({e})")
    raise last_err


def load_params(path: str, conf=None, prefer_best: bool = True) -> Dict[str, torch.Tensor]:
    """The V2 model's state_dict from the JAX package's orbax checkpoint
    directory (``best_params`` preferred, then ``params``, through
    ``state_dict_from_flax``) or from a ``.pt`` file
    (``load_reference_checkpoint``: ``best_state_dict`` preferred): JAX
    ``load_params``, and the reference's ``transcribe.py:49-62``."""
    if os.path.isfile(path):
        return load_reference_checkpoint(path, prefer_best=prefer_best)
    prefer = ("best_params", "params") if prefer_best else ("params",)
    ckpt = load_orbax_checkpoint(path, prefer=prefer)
    (params,) = ckpt.values()
    return state_dict_from_flax(params, conf)


class ResumePlan(NamedTuple):
    """What a trainer given ``saved_filename`` starts from, and where it
    saves.  ``kind``: ``"fresh"``, ``"port"`` (a ``torch.save`` file) or
    ``"jax"`` (the JAX package's orbax directory); ``source`` is the path
    to load (None for a fresh run)."""

    kind: str
    source: Optional[str]
    save_path: str


def resolve_checkpoint(saved_filename: str) -> ResumePlan:
    """Where a trainer given ``saved_filename`` resumes from and saves to.

    - ``saved_filename + ".pt"`` (or its ``.new``/``.old``) holds a port
      checkpoint: it resumes from it and saves there.  Only a run that
      resumed from a JAX directory at ``saved_filename`` writes it.
    - Nothing at ``saved_filename``, its ``.new`` or its ``.old``: a fresh
      run, saving to ``saved_filename``.
    - Files there: the port's own checkpoint, resumed and saved in place.
    - The JAX package's checkpoint directory there (``_METADATA`` in one of
      the three; ``load_orbax_checkpoint`` picks the candidate in JAX's
      crash-recovery order): resumed from, never written, moved or removed;
      the run saves to ``saved_filename + ".pt"``.
    - A directory that holds no orbax checkpoint is refused."""
    path = os.path.abspath(saved_filename.rstrip("/"))
    beside = path + ".pt"
    if checkpoint_exists(beside):
        return ResumePlan("port", beside, beside)
    found = [p for p in (path, path + ".new", path + ".old") if os.path.lexists(p)]
    if not found:
        return ResumePlan("fresh", None, path)
    dirs = [p for p in found if os.path.isdir(p)]
    if not dirs:
        return ResumePlan("port", path, path)
    if not any(os.path.isfile(os.path.join(p, "_METADATA")) for p in dirs):
        raise ValueError(f"{', '.join(dirs)}: a directory that holds no orbax checkpoint (no _METADATA); "
                         f"give the trainer a checkpoint file's path, a JAX checkpoint directory, or a "
                         f"path where nothing stands")
    return ResumePlan("jax", path, beside)


def _like(what: str, got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> None:
    """Refuse ``got`` unless it has ``want``'s keys and shapes, naming the
    first leaf that differs."""
    for key in [*want, *(k for k in got if k not in want)]:
        if key not in got:
            raise ValueError(f"{what}: the checkpoint has no {key}, which the conf's model has")
        if key not in want:
            raise ValueError(f"{what}: the checkpoint's {key} is not in the conf's model")
        if tuple(got[key].shape) != tuple(want[key].shape):
            raise ValueError(f"{what}: {key} is {list(got[key].shape)} in the checkpoint, "
                             f"{list(want[key].shape)} in the conf's model")


def restore_train_state_from_orbax(state: TrainState, tree: Dict[str, Any], conf=None) -> Dict[str, Any]:
    """Load the JAX trainer's checkpoint ``tree`` (``load_orbax_checkpoint``)
    into ``state``, as the JAX trainer resumes it
    (``transkun_tpu/cli/train.py:191-211``), and return it as the port's
    checkpoint dict (``state_dict``, ``best_state_dict``, ``optimizer``,
    ``clip_buffer``, ``clip_count``, ``step``, ``extra``).

    ``params`` and ``best_params`` (else ``params``) go through
    ``state_dict_from_flax``; ``opt_state[0].mu`` / ``.nu`` have the params'
    tree without its ``params`` root and go through it too, into
    ``AdaBelief.mu`` / ``.nu`` by parameter name; ``opt_state[0].count``
    (scale_by_belief's) and ``opt_state[2].count`` (the scheduled scale's)
    must be equal and become ``AdaBelief.count``; ``opt_state[1]``, the
    masked decay's, holds nothing.  ``clip_buffer`` / ``clip_count`` go to
    ``QuantileClip.load`` and ``step`` to ``state.step``.  ``extra``:
    ``epoch`` and ``run_seed`` as ints, ``loss_tracker`` as lists of floats,
    any other key (``warmstart_from``) as a Python value.  A checkpoint
    whose shapes differ from the conf's model is refused, naming the first
    leaf that differs: the JAX resume is not tolerant either."""
    model_sd = state.model.module.state_dict()
    opt = tree.get("opt_state")
    if not (isinstance(opt, list) and len(opt) == 3 and isinstance(opt[0], dict)
            and {"count", "mu", "nu"} <= set(opt[0]) and isinstance(opt[2], dict) and "count" in opt[2]):
        raise ValueError("opt_state is not the JAX trainer's optimizer state (scale_by_belief, masked "
                         "decay, scheduled scale)")
    counts = int(opt[0]["count"]), int(opt[2]["count"])
    if counts[0] != counts[1]:
        raise ValueError(f"opt_state/0/count ({counts[0]}) and opt_state/2/count ({counts[1]}) differ: "
                         f"AdaBelief keeps one count")

    def converted(what, flax_tree):
        try:
            sd = state_dict_from_flax(flax_tree, conf)
        except KeyError as e:
            raise ValueError(f"{what}: the checkpoint has no leaf {e}, which the conf's model has") from None
        _like(what, sd, model_sd)
        return sd

    params = converted("params", tree["params"])
    best = converted("best_params", tree["best_params"]) if "best_params" in tree else params
    mu, nu = converted("opt_state/0/mu", opt[0]["mu"]), converted("opt_state/0/nu", opt[0]["nu"])

    extra = {}
    for key, value in (tree.get("extra") or {}).items():
        if key == "loss_tracker":
            extra[key] = {name: [float(x) for x in values] for name, values in value.items()}
        elif key in ("epoch", "run_seed"):
            extra[key] = int(value)
        else:  # a 0-d leaf as a Python number
            extra[key] = value.item() if isinstance(value, np.ndarray) and value.ndim == 0 else value
    ckpt = {
        "state_dict": params,
        "best_state_dict": best,
        "optimizer": {"count": torch.tensor(counts[0], dtype=torch.int32), "mu": mu, "nu": nu},
        "clip_buffer": torch.from_numpy(np.array(tree["clip_buffer"], dtype=np.float32)),
        "clip_count": torch.tensor(int(tree["clip_count"]), dtype=torch.int32),
        "step": int(tree["step"]),
        "extra": extra,
    }
    restore_train_state(state, ckpt)
    return ckpt
