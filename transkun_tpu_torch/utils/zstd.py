"""A Zstandard frame decoder (RFC 8878) in Python and numpy.

It reads what the JAX package's checkpoints hold (every zarr chunk and every
OCDBT manifest and node is a zstd frame) without a compression package.
Decoding goes in three phases, so that the costly one runs over every frame
of a call at once:

1. each frame's headers, literal sections and sequences are parsed (the
   sequences with their FSE tables, one sequence at a time);
2. every Huffman-coded literal stream of every frame is decoded together in
   lock-step: one numpy step decodes one symbol of each stream, a window of
   11 bits looked up in that stream's table (a random float32 weight is
   almost all literals, so this is where the time goes);
3. each frame's sequences are executed into its output (literal runs and
   match copies by ``bytearray`` slicing) and its checksum, if it has one,
   is held against XXH64.

Everything the format allows is read: skippable frames and frames back to
back, every frame-header form, raw, RLE and compressed blocks, raw, RLE,
Huffman (1 or 4 streams) and treeless literals, direct and FSE-coded Huffman
weights, the four table modes of the sequence codes, the repeat offsets.
Dictionaries and reserved bits are refused by name.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["ZstdError", "decompress", "decompress_many", "xxh64"]

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 * 1024
# RFC 8878 4.2.1: Max_Number_of_Bits is at most 11, so each lock-step
# lookup reads 11 bits, in a table of 2**11 entries
HUF_MAX_BITS = 11
HUF_TABLE = 1 << HUF_MAX_BITS


class ZstdError(ValueError):
    """A frame that is corrupt or uses a feature this decoder refuses."""


# --------------------------------------------------------------------------- bits

class _BackwardBits:
    """A bitstream read from its end (FSE and sequence streams): the last
    byte's highest set bit marks the start; reads past the first bit give
    zeros, and ``overflowed`` says that happened."""

    __slots__ = ("data", "pos")

    def __init__(self, data):
        if len(data) == 0 or data[-1] == 0:
            raise ZstdError("bitstream without its end mark")
        self.data = bytes(data)
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1  # bits left

    def read(self, nb: int) -> int:
        if nb == 0:
            return 0
        pos = self.pos - nb
        self.pos = pos
        if pos >= 0:
            lo = pos >> 3
            chunk = int.from_bytes(self.data[lo:lo + (((pos & 7) + nb + 7) >> 3)], "little")
            return (chunk >> (pos & 7)) & ((1 << nb) - 1)
        top = pos + nb
        if top <= 0:
            return 0
        chunk = int.from_bytes(self.data[:(top + 7) >> 3], "little") & ((1 << top) - 1)
        return chunk << (-pos)

    @property
    def overflowed(self) -> bool:
        return self.pos < 0


# --------------------------------------------------------------------------- FSE

def _read_fse_description(data, start: int, max_symbol: int, max_log: int) -> Tuple[List[int], int, int]:
    """An FSE table description (RFC 8878 4.1.1) at ``data[start:]``:
    (normalized counts, accuracy log, bytes read)."""
    # a description is at most a few hundred bytes: 256 weights of 7 bits
    window = bytes(data[start:start + 512])
    bits, avail = int.from_bytes(window, "little"), 8 * len(window)
    consumed = 0

    def peek(n):
        if consumed + n > avail:
            raise ZstdError("FSE table description runs past its block")
        return (bits >> consumed) & ((1 << n) - 1)

    log = peek(4) + 5
    consumed += 4
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} is above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    counts: List[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            while True:
                rep = peek(2)
                consumed += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol:
                break
        biggest = 2 * threshold - 1 - remaining
        low = peek(nb - 1)
        if low < biggest:
            value = low
            consumed += nb - 1
        else:
            value = peek(nb)
            if value >= threshold:
                value -= biggest
            consumed += nb
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nb = remaining.bit_length()
            threshold = 1 << (nb - 1)
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("FSE table description is corrupt")
    return counts, log, (consumed + 7) >> 3


def _build_fse_table(counts: Sequence[int], log: int):
    """The decoding table of normalized ``counts``: three lists indexed by
    state, (symbol, bits to read, base of the next state)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    next_count = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            next_count[s] = 1
        else:
            next_count[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE table is corrupt")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        x = next_count[symbol[u]]
        next_count[symbol[u]] = x + 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return symbol, nbits, base, log


def _rle_fse_table(sym: int):
    return [sym], [0], [0], 0


# the predefined distributions of RFC 8878 3.1.1.3.2.2
_LL_DEFAULT = _build_fse_table(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
     -1, -1, -1, -1], 6)
_ML_DEFAULT = _build_fse_table(
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = _build_fse_table(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], 5)

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                              4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_MAX_LL, _MAX_ML, _MAX_OF = 35, 52, 31


# --------------------------------------------------------------------------- Huffman

def _huffman_weights_fse(data, start: int, size: int) -> List[int]:
    """Huffman weights compressed with FSE (RFC 8878 4.2.1.2): two states
    share one backward stream until it overflows."""
    counts, log, used = _read_fse_description(data, start, HUF_MAX_BITS + 1, 6)
    sym, nbits, base, log = _build_fse_table(counts, log)
    stream = data[start + used:start + size]
    bits = _BackwardBits(stream)
    s1 = bits.read(log)
    s2 = bits.read(log)
    out: List[int] = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.overflowed:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.overflowed:
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise ZstdError("too many Huffman weights")
    return out


def _read_huffman_table(data, start: int) -> Tuple[np.ndarray, int]:
    """A Huffman tree description at ``data[start:]``: the lookup table of
    ``HUF_TABLE`` entries, each ``symbol | bits << 8``, and bytes read."""
    header = data[start]
    if header >= 128:
        n = header - 127
        size = (n + 1) // 2
        raw = data[start + 1:start + 1 + size]
        if len(raw) < size:
            raise ZstdError("Huffman weights run past their block")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        weights = weights[:n]
    else:
        size = header
        weights = _huffman_weights_fse(data, start + 1, size)
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights are all zero")
    max_bits = total.bit_length()  # highbit(total) + 1
    rest = (1 << max_bits) - total
    if max_bits > HUF_MAX_BITS or rest & (rest - 1):
        raise ZstdError("Huffman weights are corrupt")
    weights = weights + [rest.bit_length()]
    if len(weights) > 256:
        raise ZstdError("more than 256 Huffman weights")
    w = np.asarray(weights, np.int64)
    sym = np.arange(len(weights))
    used = w > 0
    # codes go to symbols by weight, then by symbol value: lowest weight first
    order = np.lexsort((sym[used], w[used]))
    sw, ss = w[used][order], sym[used][order]
    nb = max_bits + 1 - sw
    entries = np.repeat(ss | (nb << 8), 1 << (sw - 1))
    table = np.repeat(entries, 1 << (HUF_MAX_BITS - max_bits)).astype(np.int32)
    return table, 1 + size


class _Literals:
    """A block's literals: bytes known now, or Huffman streams the batch
    decodes (``streams``: (stream bytes, symbols, table id))."""

    __slots__ = ("data", "streams")

    def __init__(self, data=None, streams=None):
        self.data = data
        self.streams = streams


def _decode_huffman_streams(jobs, tables: List[np.ndarray]) -> List[bytes]:
    """Every stream of ``jobs`` at once: lock-step decoding, lanes sorted by
    length so the active ones are a prefix."""
    if not jobs:
        return []
    pad = 2  # zero bytes before each stream: the window below its first bit
    sizes = [len(s) for s, _, _ in jobs]
    starts = np.cumsum([0] + [n + pad for n in sizes])[:-1] + pad
    buf = bytearray(int(starts[-1]) + sizes[-1] + 4)
    for (stream, _, _), at in zip(jobs, starts.tolist()):
        buf[at:at + len(stream)] = stream
    n = len(buf) - 3
    g = np.frombuffer(bytes(buf), np.uint8).astype(np.uint32)
    words = g[:n] | (g[1:n + 1] << 8) | (g[2:n + 2] << 16) | (g[3:n + 3] << 24)
    table = np.concatenate(tables)
    lengths = np.array([k for _, k, _ in jobs], np.int64)
    order = np.argsort(-lengths, kind="stable")
    bases, tops, toff = [], [], []
    for j in order.tolist():
        stream, _, tid = jobs[j]
        if not stream or stream[-1] == 0:
            raise ZstdError("Huffman stream without its end mark")
        at = int(starts[j])
        bases.append(8 * at)
        tops.append(8 * at + 8 * (len(stream) - 1) + stream[-1].bit_length() - 1)
        toff.append(tid * HUF_TABLE)
    pos = np.array(tops, np.int64)
    toff = np.array(toff, np.int64)
    lens = lengths[order]
    longest = int(lens[0])
    out = np.zeros((longest, len(jobs)), np.uint8)
    # active[i]: lanes with more than i symbols
    active = len(jobs) - np.searchsorted(lens[::-1], np.arange(longest), side="right")
    try:
        for i in range(longest):
            a = int(active[i])
            p = pos[:a]
            q = p - HUF_MAX_BITS
            e = table[toff[:a] + ((words[q >> 3] >> (q & 7)) & (HUF_TABLE - 1))]
            out[i, :a] = e
            p -= e >> 8
    except IndexError as err:  # a corrupt stream read far below its start
        raise ZstdError("Huffman stream is corrupt") from err
    if not np.array_equal(pos, np.array(bases, np.int64)):
        raise ZstdError("Huffman stream is corrupt")
    out = np.ascontiguousarray(out.T)  # a lane's symbols on one row
    result: List[bytes] = [b""] * len(jobs)
    for lane, j in enumerate(order.tolist()):
        result[j] = out[lane, :int(lens[lane])].tobytes()
    return result


# --------------------------------------------------------------------------- blocks

class _FrameState:
    """What carries from block to block within a frame."""

    def __init__(self):
        self.huffman = None   # table id of the last Huffman table
        self.ll = self.of = self.ml = None
        self.reps = [1, 4, 8]


def _parse_literals(block, state: _FrameState, tables: List[np.ndarray], jobs) -> Tuple[_Literals, int]:
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw or RLE
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) | (block[1] << 4), 2
        else:
            size, head = (b0 >> 4) | (block[1] << 4) | (block[2] << 12), 3
        if kind == 0:
            data = bytes(block[head:head + size])
            if len(data) != size:
                raise ZstdError("raw literals run past their block")
            return _Literals(data=data), head + size
        if len(block) <= head:
            raise ZstdError("RLE literals run past their block")
        return _Literals(data=bytes([block[head]]) * size), head + 1
    head = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    v = int.from_bytes(block[:head], "little") >> 4
    width = {3: 10, 4: 14, 5: 18}[head]
    regen, csize = v & ((1 << width) - 1), v >> width
    if regen > BLOCK_MAX:
        raise ZstdError("literals larger than a block")
    body = block[head:head + csize]
    if len(body) != csize:
        raise ZstdError("compressed literals run past their block")
    at = 0
    if kind == 2:
        table, at = _read_huffman_table(body, 0)
        tables.append(table)
        state.huffman = len(tables) - 1
    elif state.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    tid = state.huffman
    if fmt == 0:
        streams = [(bytes(body[at:]), regen, tid)]
    else:
        if csize - at < 6:
            raise ZstdError("jump table runs past its block")
        s1, s2, s3 = (int.from_bytes(body[at + 2 * k:at + 2 * k + 2], "little") for k in range(3))
        per = (regen + 3) // 4
        edges = [at + 6, at + 6 + s1, at + 6 + s1 + s2, at + 6 + s1 + s2 + s3, csize]
        if edges[3] > csize or regen < 3 * per:
            raise ZstdError("Huffman streams are corrupt")
        counts = [per, per, per, regen - 3 * per]
        streams = [(bytes(body[edges[k]:edges[k + 1]]), counts[k], tid) for k in range(4)]
    first = len(jobs)
    jobs.extend(streams)
    return _Literals(streams=list(range(first, len(jobs)))), head + csize


def _sequence_table(block, at: int, mode: int, default, max_symbol: int, max_log: int, previous, name):
    if mode == 0:
        return default, at
    if mode == 1:
        if at >= len(block):
            raise ZstdError("sequence section runs past its block")
        if block[at] > max_symbol:
            raise ZstdError(f"{name} code {block[at]} out of range")
        return _rle_fse_table(block[at]), at + 1
    if mode == 2:
        counts, log, used = _read_fse_description(block, at, max_symbol, max_log)
        return _build_fse_table(counts, log), at + used
    if previous is None:
        raise ZstdError(f"repeat mode for {name} without an earlier table")
    return previous, at


def _parse_sequences(block, state: _FrameState) -> List[Tuple[int, int, int]]:
    """(literal length, match length, offset) of every sequence, the
    offsets resolved against the repeat offsets."""
    if not block:
        raise ZstdError("sequence section missing")
    b0 = block[0]
    if b0 == 0:
        if len(block) != 1:
            raise ZstdError("bytes after an empty sequence section")
        return []
    if b0 < 128:
        n, at = b0, 1
    elif b0 < 255:
        n, at = ((b0 - 128) << 8) + block[1], 2
    else:
        n, at = block[1] + (block[2] << 8) + 0x7F00, 3
    modes = block[at]
    at += 1
    if modes & 3:
        raise ZstdError("reserved bits of the sequence modes are set")
    state.ll, at = _sequence_table(block, at, modes >> 6, _LL_DEFAULT, _MAX_LL, 9, state.ll, "literal length")
    state.of, at = _sequence_table(block, at, (modes >> 4) & 3, _OF_DEFAULT, _MAX_OF, 8, state.of, "offset")
    state.ml, at = _sequence_table(block, at, (modes >> 2) & 3, _ML_DEFAULT, _MAX_ML, 9, state.ml, "match length")
    ll_sym, ll_nb, ll_base, ll_log = state.ll
    of_sym, of_nb, of_base, of_log = state.of
    ml_sym, ml_nb, ml_base, ml_log = state.ml
    bits = _BackwardBits(block[at:])
    read = bits.read
    s_ll, s_of, s_ml = read(ll_log), read(of_log), read(ml_log)
    reps = state.reps
    out = []
    for k in range(n):
        oc, mc, lc = of_sym[s_of], ml_sym[s_ml], ll_sym[s_ll]
        if oc > _MAX_OF:
            raise ZstdError("offset code out of range")
        value = (1 << oc) + read(oc)
        ml = _ML_BASE[mc] + read(_ML_BITS[mc])
        ll = _LL_BASE[lc] + read(_LL_BITS[lc])
        if value > 3:
            offset = value - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            idx = value - 1 + (ll == 0)
            if idx == 0:
                offset = reps[0]
            else:
                offset = reps[0] - 1 if idx == 3 else reps[idx]
                if offset == 0:
                    raise ZstdError("repeat offset of 0")
                if idx != 1:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], offset
        out.append((ll, ml, offset))
        if k + 1 < n:
            s_ll = ll_base[s_ll] + read(ll_nb[s_ll])
            s_ml = ml_base[s_ml] + read(ml_nb[s_ml])
            s_of = of_base[s_of] + read(of_nb[s_of])
    if bits.pos != 0:
        raise ZstdError("sequence bitstream is corrupt")
    return out


# --------------------------------------------------------------------------- frames

class _Frame:
    __slots__ = ("blocks", "content_size", "checksum", "window")

    def __init__(self):
        self.blocks = []  # ("raw", bytes) | ("rle", byte, n) | ("seq", _Literals, sequences)
        self.content_size = None
        self.checksum = None
        self.window = 0


def _parse_frame(data, at: int, tables, jobs) -> Tuple[_Frame, int]:
    desc = data[at]
    at += 1
    fcs_flag, single = desc >> 6, (desc >> 5) & 1
    if desc & 0x08:
        raise ZstdError("reserved bit of the frame header is set")
    frame = _Frame()
    window = None
    if not single:
        wd = data[at]
        at += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[desc & 3]
    if did_size:
        did = int.from_bytes(data[at:at + did_size], "little")
        at += did_size
        if did != 0:
            raise ZstdError(f"frame needs dictionary {did}; dictionaries are not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if fcs_size:
        fcs = int.from_bytes(data[at:at + fcs_size], "little")
        at += fcs_size
        frame.content_size = fcs + 256 if fcs_size == 2 else fcs
    if window is None:
        window = frame.content_size
    frame.window = window
    block_max = min(window, BLOCK_MAX)
    state = _FrameState()
    while True:
        if at + 3 > len(data):
            raise ZstdError("block header runs past the input")
        h = int.from_bytes(data[at:at + 3], "little")
        at += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ZstdError("reserved block type")
        if kind == 1:
            if at + 1 > len(data):
                raise ZstdError("RLE block runs past the input")
            if size > block_max:
                raise ZstdError("block larger than its maximum")
            frame.blocks.append(("rle", data[at], size))
            at += 1
        else:
            if size > block_max or at + size > len(data):
                raise ZstdError("block runs past the input or its maximum")
            block = data[at:at + size]
            at += size
            if kind == 0:
                frame.blocks.append(("raw", bytes(block)))
            else:
                literals, used = _parse_literals(block, state, tables, jobs)
                sequences = _parse_sequences(block[used:], state)
                frame.blocks.append(("seq", literals, sequences))
        if last:
            break
    if desc & 0x04:
        if at + 4 > len(data):
            raise ZstdError("checksum runs past the input")
        frame.checksum = int.from_bytes(data[at:at + 4], "little")
        at += 4
    return frame, at


def _execute(frame: _Frame, decoded: List[bytes]) -> bytes:
    out = bytearray()
    for block in frame.blocks:
        start = len(out)
        if block[0] == "raw":
            out += block[1]
        elif block[0] == "rle":
            out += bytes([block[1]]) * block[2]
        else:
            lit = block[1]
            literals = lit.data if lit.data is not None else b"".join(decoded[j] for j in lit.streams)
            li = 0
            for ll, ml, offset in block[2]:
                if ll:
                    if li + ll > len(literals):
                        raise ZstdError("sequence takes more literals than the block has")
                    out += literals[li:li + ll]
                    li += ll
                if offset > len(out) or offset > frame.window:
                    raise ZstdError("match offset reaches before the frame's start")
                src = len(out) - offset
                if offset >= ml:
                    out += out[src:src + ml]
                else:
                    piece = out[src:]
                    out += (piece * (ml // offset + 1))[:ml]
            out += literals[li:]
        if len(out) - start > BLOCK_MAX:
            raise ZstdError("block decodes to more than its maximum")
    if frame.content_size is not None and len(out) != frame.content_size:
        raise ZstdError(f"frame decodes to {len(out)} bytes, its header says {frame.content_size}")
    if frame.checksum is not None and xxh64(out) & 0xFFFFFFFF != frame.checksum:
        raise ZstdError("content checksum does not match")
    return bytes(out)


def decompress_many(buffers: Sequence[bytes]) -> List[bytes]:
    """Decode each buffer (zstd frames and skippable frames back to back)
    into its bytes; the Huffman streams of every buffer decode together."""
    tables: List[np.ndarray] = []
    jobs: list = []
    parsed = []
    for data in buffers:
        data = bytes(data)
        frames, at = [], 0
        if len(data) == 0:
            raise ZstdError("empty input")
        while at < len(data):
            if at + 4 > len(data):
                raise ZstdError("truncated frame magic")
            magic = int.from_bytes(data[at:at + 4], "little")
            if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
                if at + 8 > len(data):
                    raise ZstdError("truncated skippable frame")
                at += 8 + int.from_bytes(data[at + 4:at + 8], "little")
                if at > len(data):
                    raise ZstdError("skippable frame runs past the input")
                continue
            if magic != FRAME_MAGIC:
                raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
            try:
                frame, at = _parse_frame(data, at + 4, tables, jobs)
            except IndexError as e:  # a header read past the end of the input
                raise ZstdError("frame runs past the end of its input") from e
            frames.append(frame)
        parsed.append(frames)
    decoded = _decode_huffman_streams(jobs, tables)
    return [b"".join(_execute(f, decoded) for f in frames) for frames in parsed]


def decompress(data: bytes) -> bytes:
    """Decode ``data``: zstd frames and skippable frames back to back."""
    return decompress_many([data])[0]


# --------------------------------------------------------------------------- XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the zstd content checksum is its low 32 bits)."""
    data = bytes(data)
    n = len(data)
    at = 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data[:32 * stripes], "<u8").reshape(stripes, 4).tolist()
        for a, b, c, d in lanes:
            v1 = (_rotl((v1 + a * _P2) & _M64, 31) * _P1) & _M64
            v2 = (_rotl((v2 + b * _P2) & _M64, 31) * _P1) & _M64
            v3 = (_rotl((v3 + c * _P2) & _M64, 31) * _P1) & _M64
            v4 = (_rotl((v4 + d * _P2) & _M64, 31) * _P1) & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        at = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while at + 8 <= n:
        k = _round(0, int.from_bytes(data[at:at + 8], "little"))
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        at += 8
    if at + 4 <= n:
        h = (_rotl(h ^ ((int.from_bytes(data[at:at + 4], "little") * _P1) & _M64), 23) * _P2 + _P3) & _M64
        at += 4
    while at < n:
        h = (_rotl(h ^ ((data[at] * _P5) & _M64), 11) * _P1) & _M64
        at += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h
