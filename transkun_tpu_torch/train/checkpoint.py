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
and the next is tried.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any, Dict, Optional, Sequence

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
