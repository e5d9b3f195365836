"""Read a checkpoint that the JAX package wrote with orbax
(``transkun_tpu/train/checkpoint.py::save_checkpoint``) into a tree of
numpy arrays, ints and strings, without orbax, tensorstore or JAX.

An orbax PyTree checkpoint directory holds:

- ``_METADATA``: JSON, the tree: every leaf's key path (dict keys and
  sequence indices) and value type (``jax.Array``, ``np.ndarray``,
  ``scalar``, ``string``, ``None``, or ``List``, ``Dict`` or ``Tuple`` for
  an empty container, such as the JAX trainer's ``loss_tracker["val"]``
  before its first validation);
- ``_strings.json``: the string leaves, by dotted key path;
- an OCDBT database (``utils/ocdbt.py``) under which every array leaf is a
  zarr v2 array named by its dotted key path: ``<name>/.zarray`` (JSON:
  shape, chunks, dtype, compressor, fill value) and one value a chunk,
  ``<name>/0.0`` and so on, each compressed with zstd (``utils/zstd.py``)
  or stored raw.

Leaves come back as JAX ``load_checkpoint(path, to_host=True)`` returns
them: arrays and scalars as ``np.ndarray`` (a scalar 0-d), strings as
``str``, a ``None`` leaf as ``None``, an empty container as ``[]``, ``{}``
or ``()``; sequences as lists.  Any other value type is refused by name.  Any zarr
compressor, filter, dtype, order or format other than those orbax writes
here (zstd or no compressor, no filters, order C, "." between chunk
indices, the dtypes of ``DTYPES``) is refused by name.
"""

from __future__ import annotations

import json
import math
import os
from itertools import product
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ocdbt import OcdbtStore
from .zstd import decompress_many

__all__ = ["OrbaxCheckpoint", "OrbaxFormatError"]

DTYPES = ("<f4", "<f8", "<i4", "<i8", "|b1", "<u4")
ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
# orbax writes an empty container as a leaf of its own; JAX restores it as this
EMPTY_CONTAINERS = {"List": list, "Dict": dict, "Tuple": tuple}
KEY_DICT, KEY_SEQUENCE = 2, 1


class OrbaxFormatError(ValueError):
    """A checkpoint directory this reader cannot or will not read."""


def _fill(value, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named:
            raise OrbaxFormatError(f"zarr fill_value {value!r}")
        return named[value]
    return value


class _ZarrArray:
    """One zarr v2 array's metadata and the keys of its chunks."""

    def __init__(self, name: str, meta: Dict[str, Any]):
        where = f"array {name}"
        if meta.get("zarr_format") != 2:
            raise OrbaxFormatError(f"{where}: zarr_format {meta.get('zarr_format')!r}; only 2 is read")
        if meta.get("dtype") not in DTYPES:
            raise OrbaxFormatError(f"{where}: dtype {meta.get('dtype')!r}; read are {', '.join(DTYPES)}")
        if meta.get("order", "C") != "C":
            raise OrbaxFormatError(f"{where}: order {meta.get('order')!r}; only C is read")
        if meta.get("filters"):
            raise OrbaxFormatError(f"{where}: filters {meta['filters']!r}; none are read")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise OrbaxFormatError(f"{where}: compressor {compressor.get('id')!r}; read are zstd and null")
        self.name = name
        self.compressed = compressor is not None
        self.dtype = np.dtype(meta["dtype"])
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c <= 0 for c in self.chunks):
            raise OrbaxFormatError(f"{where}: chunks {list(self.chunks)} do not fit shape {list(self.shape)}")
        self.fill_value = _fill(meta.get("fill_value"), self.dtype)
        if meta.get("dimension_separator", ".") != ".":
            raise OrbaxFormatError(f"{where}: dimension_separator {meta['dimension_separator']!r}; "
                                   f"only '.' is read")

    def chunk_indices(self) -> List[Tuple[int, ...]]:
        return list(product(*(range(math.ceil(s / c)) for s, c in zip(self.shape, self.chunks))))

    def chunk_key(self, index: Tuple[int, ...]) -> str:
        return f"{self.name}/" + (".".join(map(str, index)) if index else "0")

    def assemble(self, chunks: Dict[Tuple[int, ...], Optional[bytes]]) -> np.ndarray:
        out = np.full(self.shape, self.fill_value, self.dtype)
        expected = math.prod(self.chunks) * self.dtype.itemsize
        for index, raw in chunks.items():
            if raw is None:
                continue  # absent: the fill value
            if len(raw) != expected:
                raise OrbaxFormatError(
                    f"array {self.name}: chunk {index} holds {len(raw)} bytes, not {expected}")
            block = np.frombuffer(raw, self.dtype).reshape(self.chunks)
            # an edge chunk is stored whole; only its part inside the shape counts
            dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, self.chunks, self.shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out


class OrbaxCheckpoint:
    """The orbax checkpoint directory at ``path``."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        if not os.path.isdir(self.path):
            raise FileNotFoundError(f"{self.path} is not a directory")
        meta_path = os.path.join(self.path, "_METADATA")
        if not os.path.isfile(meta_path):
            found = sorted(os.listdir(self.path))
            shown = ", ".join(found[:8]) + (", ..." if len(found) > 8 else "")
            raise OrbaxFormatError(
                f"{self.path} is not an orbax checkpoint: no _METADATA; it holds "
                f"{len(found)} entries ({shown or 'none'})")
        with open(meta_path) as f:
            meta = json.load(f)
        if "tree_metadata" not in meta:
            raise OrbaxFormatError(f"{meta_path} has no tree_metadata")
        if meta.get("use_zarr3"):
            raise OrbaxFormatError(f"{self.path}: zarr v3 arrays (use_zarr3) are not read")
        if meta.get("use_ocdbt") is False:
            raise OrbaxFormatError(f"{self.path}: arrays outside OCDBT (use_ocdbt false) are not read")
        self.leaves: List[Tuple[Tuple[Tuple[str, int], ...], Dict[str, Any]]] = []
        for entry in meta["tree_metadata"].values():
            keys = tuple((k["key"], k["key_type"]) for k in entry["key_metadata"])
            self.leaves.append((keys, entry["value_metadata"]))
        strings_path = os.path.join(self.path, "_strings.json")
        self.strings: Dict[str, str] = {}
        if os.path.isfile(strings_path):
            with open(strings_path) as f:
                self.strings = json.load(f)
        self._store: Optional[OcdbtStore] = None

    @property
    def store(self) -> OcdbtStore:
        if self._store is None:
            self._store = OcdbtStore(self.path)
        return self._store

    def top_level_keys(self) -> List[str]:
        """The tree's top-level keys, in the order of ``_METADATA``."""
        return list(dict.fromkeys(keys[0][0] for keys, _ in self.leaves if keys))

    def read(self, prefix: Sequence[str] = ()) -> Any:
        """The tree, or only the leaves whose key path starts with
        ``prefix`` (the rest of the tree is not decoded)."""
        prefix = tuple(prefix)
        chosen = [(keys, value) for keys, value in self.leaves
                  if tuple(k for k, _ in keys[:len(prefix)]) == prefix]
        if not chosen:
            raise KeyError(f"{self.path}: no leaf under {'.'.join(prefix) or 'the root'}")
        arrays: Dict[str, _ZarrArray] = {}
        for keys, value in chosen:
            kind = value.get("value_type")
            if kind in ARRAY_TYPES:
                name = ".".join(k for k, _ in keys)
                arrays[name] = _ZarrArray(name, json.loads(self.store.read(name + "/.zarray")))
            elif kind not in ("string", "None", *EMPTY_CONTAINERS):
                raise OrbaxFormatError(f"{self.path}: leaf {'.'.join(k for k, _ in keys)} "
                                       f"has value type {kind!r}")
        values = self._read_arrays(list(arrays.values()))
        tree: Dict[str, Any] = {}
        for keys, value in chosen:
            name = ".".join(k for k, _ in keys)
            kind = value["value_type"]
            if kind == "string":
                if name not in self.strings:
                    raise OrbaxFormatError(f"{self.path}: string leaf {name} missing from _strings.json")
                leaf = self.strings[name]
            elif kind == "None":
                leaf = None
            elif kind in EMPTY_CONTAINERS:
                leaf = _Empty(EMPTY_CONTAINERS[kind]())
            else:
                leaf = values[name]
            node = tree
            for key, _ in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1][0]] = leaf
        return _sequences(tree, self._sequence_nodes(chosen))

    def _sequence_nodes(self, chosen) -> set:
        """Key paths of the nodes whose children are sequence indices."""
        out = set()
        for keys, _ in chosen:
            for depth, (_, kind) in enumerate(keys):
                if kind == KEY_SEQUENCE:
                    out.add(tuple(k for k, _ in keys[:depth]))
                elif kind != KEY_DICT:
                    raise OrbaxFormatError(f"{self.path}: key type {kind} in {'.'.join(k for k, _ in keys)}")
        return out

    def _read_arrays(self, arrays: List[_ZarrArray]) -> Dict[str, np.ndarray]:
        store = self.store
        wanted, compressed = [], []
        for array in arrays:
            for index in array.chunk_indices():
                key = array.chunk_key(index)
                raw = store.read(key) if key in store else None
                wanted.append((array, index, raw))
                if raw is not None and array.compressed:
                    compressed.append(raw)
        decoded = iter(decompress_many(compressed))
        chunks: Dict[str, Dict[Tuple[int, ...], Optional[bytes]]] = {a.name: {} for a in arrays}
        for array, index, raw in wanted:
            if raw is not None and array.compressed:
                raw = next(decoded)
            chunks[array.name][index] = raw
        return {a.name: a.assemble(chunks[a.name]) for a in arrays}


class _Empty:
    """An empty-container leaf while the tree is built, so that an empty
    dict is not taken for a node."""

    def __init__(self, value):
        self.value = value


def _sequences(tree: Dict[str, Any], sequence_paths: set, path: Tuple[str, ...] = ()) -> Any:
    """Nodes keyed by sequence indices become lists, in index order; empty
    container leaves become their containers."""
    out = {k: _sequences(v, sequence_paths, path + (k,)) if isinstance(v, dict)
           else v.value if isinstance(v, _Empty) else v
           for k, v in tree.items()}
    if path in sequence_paths:
        indices = sorted(out, key=int)
        if [int(i) for i in indices] != list(range(len(indices))):
            raise OrbaxFormatError(f"sequence {'.'.join(path)} has indices {indices}")
        return [out[i] for i in indices]
    return out
