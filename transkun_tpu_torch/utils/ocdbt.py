"""A read-only OCDBT key-value store: the database format that orbax
writes a checkpoint's arrays into (tensorstore's "Optionally-Cooperative
Distributed B+Tree").

A store is a directory with ``manifest.ocdbt`` at its root and data files
that hold B+tree nodes and values.  Every manifest and node file begins with
a magic number, its length, a format version and a compression method (none
or zstd) and ends with the crc32c of all that precedes it; both are checked.

- The manifest holds the configuration, a data-file table and the newest
  versions inline; the newest version names the root node of its B+tree by
  (data file, offset, length) and height.
- A node holds its own data-file table, then its entries, column by column:
  keys prefix-compressed against the entry before; an interior node's
  entries point at child nodes, whose keys leave out the prefix that their
  parent entry says the whole subtree shares; a leaf's values are inline or
  (data file, offset, length) in a data file.
- A data file's path is the table's base path and relative path, taken
  from the directory of the manifest (orbax's multi-process layout keeps
  the per-process databases under ``ocdbt.process_<i>/``; the root manifest
  names their files by that prefix).

``OcdbtStore(path).list()`` and ``.read(key)`` are all there is: no writes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from .zstd import decompress

__all__ = ["OcdbtError", "OcdbtStore", "crc32c"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


class OcdbtError(ValueError):
    """A store that is corrupt or uses a feature this reader refuses."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Sequential reads of varints, fixed-width integers and bytes."""

    __slots__ = ("data", "at", "what")

    def __init__(self, data: bytes, what: str):
        self.data, self.at, self.what = data, 0, what

    def byte(self) -> int:
        if self.at >= len(self.data):
            raise OcdbtError(f"{self.what} ends early")
        self.at += 1
        return self.data[self.at - 1]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what} holds a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def fixed(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise OcdbtError(f"{self.what} ends early")
        self.at += n
        return self.data[self.at - n:self.at]


def _open_encoded(data: bytes, magic: int, what: str) -> _Reader:
    """Check an encoded manifest or node (header, length, crc32c) and
    return a reader over its decompressed body."""
    if len(data) < 18:
        raise OcdbtError(f"{what} is too short ({len(data)} bytes)")
    found = int.from_bytes(data[:4], "big")
    if found != magic:
        raise OcdbtError(f"{what} has magic {found:#010x}, not {magic:#010x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OcdbtError(f"{what} says it is {length} bytes long but is {len(data)}")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OcdbtError(f"{what} fails its crc32c")
    head = _Reader(data[:-4], what)
    head.at = 12
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what} has format version {version}; only 0 is read")
    compression = head.varint()
    body = data[head.at:-4]
    if compression == 1:
        body = decompress(body)
    elif compression != 0:
        raise OcdbtError(f"{what} uses compression method {compression}")
    return _Reader(body, what)


def _data_file_table(r: _Reader) -> List[str]:
    """The paths of a data-file table, base path and relative path joined."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    paths, previous = [], b""
    for i in range(n):
        if prefix[i] > len(previous):
            raise OcdbtError(f"{r.what}: data-file path prefix past the previous path")
        full = previous[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(full):
            raise OcdbtError(f"{r.what}: base path longer than its path")
        paths.append(full.decode())
        previous = full
    return paths


def _check_relative(path: str, what: str) -> str:
    parts = path.split("/")
    if path.startswith("/") or ".." in parts:
        raise OcdbtError(f"{what}: data-file path {path!r} leaves the store")
    return path


class OcdbtStore:
    """The newest version of the OCDBT database at ``path``, read only."""

    def __init__(self, path: str):
        self.root = os.path.abspath(path)
        manifest = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            raise OcdbtError(f"{self.root} holds no manifest.ocdbt")
        with open(manifest, "rb") as f:
            r = _open_encoded(f.read(), MANIFEST_MAGIC, manifest)
        r.take(16)  # the database's uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"{manifest}: manifest kind {kind} (numbered manifests) is not read")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()    # version_tree_arity_log2
        if r.varint() == 1:  # the compression the writer uses: zstd and its level
            r.fixed(4)
        files = _data_file_table(r)
        n = r.varint()
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id = r.varints(n)
        offset = r.varints(n)
        length = r.varints(n)
        self._entries: Dict[bytes, Tuple] = {}
        if n == 0:
            return
        newest = max(range(n), key=generation.__getitem__)
        self.generation = generation[newest]
        if length[newest]:
            self._walk(files, file_id[newest], offset[newest], length[newest], height[newest], b"")

    # -- reading the tree --------------------------------------------------

    def _file(self, files: List[str], file_id: int, what: str) -> str:
        if file_id >= len(files):
            raise OcdbtError(f"{what}: data file {file_id} of a table of {len(files)}")
        return os.path.join(self.root, _check_relative(files[file_id], what))

    def _read_range(self, path: str, offset: int, length: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} run past its end")
        return data

    def _walk(self, files, file_id, offset, length, height, prefix: bytes) -> None:
        where = self._file(files, file_id, "manifest")
        what = f"node at {where}:{offset}"
        r = _open_encoded(self._read_range(where, offset, length), NODE_MAGIC, what)
        found = r.byte()
        if found != height:
            raise OcdbtError(f"{what} has height {found}, its parent says {height}")
        node_files = _data_file_table(r)
        n = r.varint()
        key_prefix = [0] + r.varints(max(n - 1, 0))
        key_suffix = r.varints(n)
        if height:
            common = r.varints(n)
        keys, previous = [], b""
        for i in range(n):
            if key_prefix[i] > len(previous):
                raise OcdbtError(f"{what}: key prefix past the previous key")
            previous = previous[:key_prefix[i]] + r.take(key_suffix[i])
            keys.append(previous)
        if height:
            child_file, child_offset, child_length = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise OcdbtError(f"{what}: subtree prefix longer than its key")
                self._walk(node_files, child_file[i], child_offset[i], child_length[i],
                           height - 1, prefix + keys[i][:common[i]])
            return
        value_length = r.varints(n)
        kind = r.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k > 1 for k in kind):
            raise OcdbtError(f"{what}: unknown value kind")
        value_file, value_offset = r.varints(len(indirect)), r.varints(len(indirect))
        located = dict(zip(indirect, zip(value_file, value_offset)))
        for i in range(n):
            key = prefix + keys[i]
            if kind[i] == 0:
                self._entries[key] = ("inline", r.take(value_length[i]))
            else:
                fid, off = located[i]
                self._entries[key] = ("file", self._file(node_files, fid, what), off, value_length[i])

    # -- the store's interface ----------------------------------------------

    def list(self) -> List[bytes]:
        """Every key, in order."""
        return sorted(self._entries)

    def read(self, key) -> bytes:
        """The value under ``key`` (bytes or str); ``KeyError`` if absent."""
        if isinstance(key, str):
            key = key.encode()
        entry = self._entries[key]
        if entry[0] == "inline":
            return entry[1]
        return self._read_range(entry[1], entry[2], entry[3])

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._entries
