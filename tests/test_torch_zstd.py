"""The port's zstd decoder (``transkun_tpu_torch/utils/zstd.py``) against the
``zstandard`` package, which compresses every input here.

- seeded random float32 weights, zeros, repeated text and a mix of the three,
  at 0, 1, 100, 131,073 and 1,048,576 bytes, at levels -1, 1, 3 and 19, with
  and without the content size and the checksum;
- two frames back to back, skippable frames among them, and several buffers
  in one ``decompress_many`` call;
- a corrupted checksum, a frame that needs a dictionary and a reserved bit
  are each refused by name, and seeded corruptions raise ``ZstdError``.
"""

import numpy as np
import pytest

from transkun_tpu_torch.utils import zstd

zstandard = pytest.importorskip("zstandard", reason="the zstandard package compresses the test inputs")

SIZES = [0, 1, 100, 131_073, 1 << 20]
KINDS = ["weights", "zeros", "text", "mix"]


def _payload(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n + 17)
    weights = rng.standard_normal(n // 4 + 1).astype(np.float32).tobytes()[:n]
    text = (b"the quick brown fox jumps over the lazy dog, again and again; " * (n // 60 + 1))[:n]
    if kind == "weights":
        return weights
    if kind == "zeros":
        return bytes(n)
    if kind == "text":
        return text
    mix, at = bytearray(), 0
    while len(mix) < n:
        k = int(rng.integers(1, 5000))
        mix += [weights[at:at + k], bytes(k), text[at:at + k]][int(rng.integers(0, 3))]
        at = (at + k) % max(n, 1)
    return bytes(mix[:n])


def _compress(data: bytes, level: int = 3, content_size: bool = True, checksum: bool = False) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_content_size=content_size,
                                    write_checksum=checksum).compress(data)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_decodes_what_zstandard_writes(kind, size):
    data = _payload(kind, size)
    for level in (-1, 1, 3, 19):
        assert zstd.decompress(_compress(data, level)) == data, level
    for content_size, checksum in ((False, False), (False, True), (True, True)):
        assert zstd.decompress(_compress(data, 1, content_size, checksum)) == data, (content_size, checksum)


def test_frames_back_to_back_and_skippable_frames():
    a, b = _payload("mix", 200_000), _payload("text", 5_000)
    skip = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"ignored"
    empty_skip = (0x184D2A5F).to_bytes(4, "little") + bytes(4)
    stream = skip + _compress(a, 1) + empty_skip + _compress(b, 19, False, True) + skip
    assert zstd.decompress(stream) == a + b
    assert zstd.decompress(skip) == b""


def test_many_buffers_decode_together():
    datas = [_payload(k, n) for k in KINDS for n in (100, 131_073)]
    frames = [_compress(d, level) for d, level in zip(datas, [1, 3, -1, 19] * 2)]
    assert zstd.decompress_many(frames) == datas


def test_streaming_frame_without_content_size():
    """A frame written by the streaming compressor: a window descriptor, no
    content size, blocks of every kind the input gives."""
    data = _payload("mix", 600_000)
    cobj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    frame = b"".join([cobj.compress(data[:250_000]), cobj.compress(data[250_000:]), cobj.flush()])
    assert zstd.decompress(frame) == data


def test_direct_huffman_weights_and_rle_literals():
    """A skewed 24-letter alphabet makes zstandard write its Huffman weights
    directly, 4 bits each, not FSE-coded.  zstandard writes RLE literals
    only in rare blocks, so that frame is made by hand: a compressed block
    of 20 RLE literals and no sequences (zstandard reads it the same)."""
    rng = np.random.default_rng(3)
    p = 2.0 ** (-np.arange(24) / 3)
    skewed = rng.choice(24, 60_000, p=p / p.sum()).astype(np.uint8).tobytes()
    frame = _compress(skewed, 3)
    # magic, descriptor, 2-byte content size, block header, 5-byte literals
    # header: then the Huffman header, >= 128 for direct weights
    assert frame[4 + 1 + 2 + 3 + 5] >= 128
    assert zstd.decompress(frame) == skewed
    block = bytes([1 | (20 << 3), ord("q"), 0])  # RLE literals of size 20, then 0 sequences
    frame = (0xFD2FB528).to_bytes(4, "little") + bytes([0x20, 20]) + \
        ((len(block) << 3) | (2 << 1) | 1).to_bytes(3, "little") + block
    assert zstd.decompress(frame) == zstandard.ZstdDecompressor().decompress(frame) == b"q" * 20


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    data = _payload("weights", 1000)
    frame = _compress(data, 3, True, True)
    assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")


def test_corrupted_checksum_is_refused():
    frame = bytearray(_compress(_payload("text", 10_000), 3, True, True))
    frame[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum does not match"):
        zstd.decompress(bytes(frame))


def test_dictionary_frame_is_refused():
    samples = [_payload("text", 300 + 7 * i) + bytes([i]) * 40 for i in range(200)]
    dictionary = zstandard.train_dictionary(2048, samples)
    assert dictionary.dict_id() != 0
    frame = zstandard.ZstdCompressor(level=3, dict_data=dictionary).compress(samples[0])
    with pytest.raises(zstd.ZstdError, match=f"needs dictionary {dictionary.dict_id()}"):
        zstd.decompress(frame)


def test_reserved_bits_are_refused():
    frame = bytearray(_compress(_payload("text", 1000)))
    frame[4] |= 0x08  # the frame header descriptor's reserved bit
    with pytest.raises(zstd.ZstdError, match="reserved bit of the frame header"):
        zstd.decompress(bytes(frame))
    block = bytearray(_compress(b"abc", 3, True))
    header_end = 4 + 1 + 1  # magic, descriptor, a 1-byte content size (single segment)
    block[header_end] |= 0b110  # block type 3
    with pytest.raises(zstd.ZstdError, match="reserved block type"):
        zstd.decompress(bytes(block))


def test_corrupt_frames_raise_zstd_error():
    """Seeded bit flips and truncations of a checksummed frame: each one is
    refused with ``ZstdError`` (the checksum catches what decodes), never
    another exception."""
    rng = np.random.default_rng(11)
    data = _payload("mix", 40_000)
    frame = _compress(data, 3, True, True)
    for _ in range(80):
        bad = bytearray(frame)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(4, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        if rng.random() < 0.2:
            bad = bad[:int(rng.integers(5, len(bad)))]
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bytes(bad))
