"""The port's reader of the JAX package's orbax checkpoints
(``utils/ocdbt.py``, ``utils/orbax_read.py``, ``train/checkpoint.py``'s
``load_orbax_checkpoint`` and ``load_params``) against tensorstore, orbax
and the JAX package, on the CPU.

- the OCDBT store: ``list()`` and every ``read(key)`` equal tensorstore's on
  a checkpoint from JAX ``save_checkpoint`` and on a store with interior
  nodes, many versions, inline and indirect values;
- zarr arrays with edge chunks, an absent chunk (the fill value) and no
  compressor equal tensorstore's reading;
- the tree equals JAX ``load_checkpoint`` leaf for leaf;
- ``cli.transcribe --weight DIR`` writes the JAX CLI's notes;
- the crash-recovery order and its ``checkpoint fallback:`` line are JAX's;
- a non-orbax directory, a zarr compressor other than zstd or null, a "/"
  chunk separator and an unread dtype are refused with their messages;
- the committed fixture reads without tensorstore, orbax, zstandard, JAX or
  flax, and JAX reads it as its ``.npz`` says;
- at the flagship's width, ``load_params``'s state_dict equals
  ``state_dict_from_flax`` of JAX ``load_params``, bit for bit.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from transkun_tpu.cli.transcribe import main as jax_transcribe
from transkun_tpu.models import ModelConfig as JaxModelConfig
from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.config import load_default_conf as jax_default_conf
from transkun_tpu.train import init_train_state, make_optimizer
from transkun_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from transkun_tpu.train.checkpoint import load_params as jax_load_params
from transkun_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from transkun_tpu_torch.cli.transcribe import main as port_transcribe
from transkun_tpu_torch.data.midi import read_midi
from transkun_tpu_torch.models.config import load_default_conf
from transkun_tpu_torch.train.checkpoint import load_orbax_checkpoint, load_params
from transkun_tpu_torch.utils.convert import state_dict_from_flax
from transkun_tpu_torch.utils.ocdbt import OcdbtStore
from transkun_tpu_torch.utils.orbax_read import OrbaxCheckpoint, OrbaxFormatError

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ts = pytest.importorskip("tensorstore", reason="tensorstore is the oracle of the OCDBT store")
pytest.importorskip("orbax.checkpoint", reason="orbax writes the checkpoints")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "golden", "orbax_v2_narrow")
NARROW = dict(f_min=30, f_max=1900, n_mels=32, hopSize=64, windowSize=256, fs=4000,
              nExtraWins=2, baseSize=8, nHead=2, nLayers=1, scoringExpansionFactor=2)


def _leaves(tree):
    """(key path, leaf) of a tree of dicts and lists, None leaves kept."""
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]


def _assert_same_tree(got, want):
    assert jax.tree_util.tree_structure(got, is_leaf=lambda x: x is None) == \
        jax.tree_util.tree_structure(want, is_leaf=lambda x: x is None)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert type(a) is type(b), (path, type(a), type(b))
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
        else:
            assert a == b, path


def _state(init, seed: int, step: int):
    """A narrow V2 train state with every leaf seeded: params, both AdaBelief
    moments, the clip buffer and count, the step."""
    params = jax.tree.map(np.asarray, init)
    rng = np.random.default_rng(seed)
    noisy = lambda t: jax.tree.map(  # noqa: E731
        lambda a: (np.asarray(a) + rng.standard_normal(np.shape(a))).astype(np.asarray(a).dtype), t)
    state = init_train_state(params, make_optimizer(params["params"]))
    opt = list(state.opt_state)
    opt[0] = opt[0]._replace(count=np.int32(step), mu=noisy(opt[0].mu), nu=noisy(opt[0].nu))
    clip = state.clip_state._replace(buffer=rng.standard_normal(state.clip_state.buffer.shape).astype(np.float32),
                                     count=np.int32(3 * step))
    state = state._replace(params=noisy(params), opt_state=tuple(opt), clip_state=clip, step=np.int32(step))
    return state, noisy(params)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two narrow checkpoints from JAX ``save_checkpoint``, steps 1 and 2."""
    tmp = tmp_path_factory.mktemp("orbax")
    out = {}
    model = JaxTransKun(JaxModelConfig.from_dict(NARROW))
    init = jax.jit(lambda k: model.init(k, n_frames=33))(jax.random.PRNGKey(0))
    for step in (1, 2):
        state, best = _state(init, step, step)
        path = str(tmp / f"step{step}")
        jax_save_checkpoint(path, state, best_params=best,
                            extra={"epoch": 3 + step, "warmstart_from": "/some/donor", "lr": 0.25})
        out[step] = path
    return out


def _small_node_store(path: str) -> str:
    """An OCDBT store written by tensorstore with 300-byte nodes (interior
    nodes several levels deep), values inline and in data files, and one
    version a write (the manifest's version tree)."""
    spec = {"driver": "ocdbt", "base": f"file://{path}/",
            "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 8}}
    kv = ts.KvStore.open(spec).result()
    for i in range(120):
        kv.write(f"key{i:04d}/{'sub' * (i % 3)}".encode(), (b"v%d" % i) * (i % 7)).result()
    kv.delete_range(ts.KvStore.KeyRange(b"key0007/sub", b"key0007/sub\0")).result()
    return path


@pytest.mark.parametrize("which", ["checkpoint", "small nodes"])
def test_store_equals_tensorstore(checkpoints, tmp_path, which):
    path = checkpoints[1] if which == "checkpoint" else _small_node_store(str(tmp_path / "kv"))
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    want = sorted(kv.list().result())
    store = OcdbtStore(path)
    assert store.list() == want and len(want) > 100
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    assert b"key0007/sub" not in store


def test_tree_equals_jax_load_checkpoint(checkpoints):
    for path in checkpoints.values():
        got, want = load_orbax_checkpoint(path), jax_load_checkpoint(path)
        _assert_same_tree(got, want)
        assert int(got["step"]) == int(want["step"]) and got["extra"]["warmstart_from"] == "/some/donor"
        assert got["extra"]["epoch"].dtype == np.int64 and got["extra"]["lr"] == 0.25
        assert np.abs(got["opt_state"][0]["nu"]["scorer"]["map"]["kernel"]).max() > 0
    # only the preferred key is decoded, and it is the same tree
    best = load_orbax_checkpoint(checkpoints[2], prefer=("missing", "best_params", "params"))
    assert list(best) == ["best_params"]
    _assert_same_tree(best["best_params"], jax_load_checkpoint(checkpoints[2])["best_params"])


@pytest.mark.parametrize("layout", ["edge chunks", "absent chunk", "no compressor"])
def test_zarr_layouts_equal_tensorstore(tmp_path, layout):
    """Arrays orbax does not write here but zarr v2 allows: several chunks
    with edge chunks stored whole, a chunk never written (the fill value),
    raw chunks; held against tensorstore."""
    path = str(tmp_path / "ckpt")
    metadata = {"shape": [7, 10], "chunks": [3, 4], "dtype": "<f4", "fill_value": 1.5,
                "compressor": {"id": "zstd", "level": 1}}
    if layout == "no compressor":
        metadata["compressor"] = None
    arr = _zarr(path, metadata)
    values = np.random.default_rng(4).standard_normal((7, 10)).astype(np.float32)
    if layout == "absent chunk":
        arr[3:7, :].write(values[3:7]).result()  # the first row of chunks stays absent
    else:
        arr.write(values).result()
    got = OrbaxCheckpoint(path).read()["w"]["kernel"]
    want = arr.read().result()
    np.testing.assert_array_equal(got, want)
    if layout == "absent chunk":
        assert (got[:3] == 1.5).all()


def _zarr(path, metadata):
    """A zarr v2 array ``w.kernel`` written by tensorstore into an OCDBT
    store at ``path``, with the ``_METADATA`` of an orbax tree around it."""
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}/"},
                   "path": "w.kernel", "metadata": metadata}, create=True).result()
    _write_metadata(path, [("w", "kernel")])
    return arr


def _write_metadata(path, leaves):
    tree = {str(keys): {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                        "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False}}
            for keys in leaves}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False}, f)


def _piece(path: str, seconds: float = 8.0, fs: int = 4000) -> str:
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * fs)) / fs
    x = 0.01 * rng.standard_normal(t.shape)
    for _ in range(int(seconds * 1.5)):
        start, dur = rng.uniform(0, seconds - 1), rng.uniform(0.2, 1.0)
        freq = 440 * 2 ** ((rng.integers(40, 80) - 69) / 12)
        x += 0.2 * ((t >= start) & (t < start + dur)) * np.sin(2 * np.pi * freq * t)
    wavfile.write(path, fs, (np.clip(x, -1, 1) * 32000).astype(np.int16))
    return path


def _midi_notes(path):
    return [(n.start, n.end, n.pitch, n.velocity) for n in read_midi(path).notes]


def test_transcribe_cli_weight_dir_matches_jax(tmp_path):
    """JAX ``cli.transcribe --weight DIR`` and the port's (``--device cpu``)
    on the committed fixture and a seeded 8 s piece: equal notes."""
    wav = _piece(str(tmp_path / "piece.wav"))
    conf = FIXTURE + ".conf"
    jax_transcribe([wav, str(tmp_path / "jax.mid"), "--weight", FIXTURE, "--conf", conf])
    port_transcribe([wav, str(tmp_path / "port.mid"), "--weight", FIXTURE, "--conf", conf,
                     "--device", "cpu"])
    want = _midi_notes(str(tmp_path / "jax.mid"))
    assert len(want) > 20
    assert _midi_notes(str(tmp_path / "port.mid")) == want


@pytest.mark.parametrize("case", ["complete new", "new missing a data file", "old last resort"])
def test_crash_recovery_order_is_jaxs(checkpoints, tmp_path, capsys, case):
    """``path.new`` (step 2) over ``path`` (step 1); a ``.new`` with a data
    file removed falls back to ``path`` with the ``checkpoint fallback:``
    line; with ``path`` broken too, ``path.old`` is the last resort.  JAX
    ``load_checkpoint`` on the same layout is the oracle."""
    path = str(tmp_path / "ckpt")
    shutil.copytree(checkpoints[1], path)
    shutil.copytree(checkpoints[2], path + ".new")
    if case != "complete new":
        _remove_largest_data_file(path + ".new")
    if case == "old last resort":
        shutil.copytree(path, path + ".old")
        _remove_largest_data_file(path)
    capsys.readouterr()
    got = load_orbax_checkpoint(path)
    port_out = capsys.readouterr().out
    want = jax_load_checkpoint(path)
    jax_out = capsys.readouterr().out
    expected_step = {"complete new": 2, "new missing a data file": 1, "old last resort": 1}[case]
    assert int(got["step"]) == int(want["step"]) == expected_step
    _assert_same_tree(got, want)
    fell_back = f"checkpoint fallback: {path}.new unreadable"
    assert (fell_back in port_out) == (fell_back in jax_out) == (case != "complete new")
    assert "checkpoint fallback: " + path + " " not in port_out


def _remove_largest_data_file(path):
    data = os.path.join(path, "ocdbt.process_0", "d")
    os.remove(os.path.join(data, max(os.listdir(data), key=lambda n: os.path.getsize(os.path.join(data, n)))))


def test_refusals(tmp_path):
    """A directory that is not an orbax checkpoint says what it holds; a
    zarr compressor other than zstd or null, a "/" between chunk indices and
    a dtype outside the read ones are refused by name."""
    plain = tmp_path / "not_a_checkpoint"
    plain.mkdir()
    (plain / "weights.bin").write_bytes(b"\0" * 8)
    (plain / "notes.txt").write_text("x")
    with pytest.raises(OrbaxFormatError, match=r"is not an orbax checkpoint: no _METADATA; it holds "
                                               r"2 entries \(notes.txt, weights.bin\)"):
        load_params(str(plain), None)
    for name, metadata, message in (
            ("zlib", {"compressor": {"id": "zlib", "level": 1}},
             "array w.kernel: compressor 'zlib'; read are zstd and null"),
            ("slash", {"dimension_separator": "/"},
             "array w.kernel: dimension_separator '/'; only '.' is read"),
            ("f2", {"dtype": "<f2"}, "array w.kernel: dtype '<f2'; read are")):
        path = str(tmp_path / name)
        _zarr(path, {"shape": [4], "chunks": [4], "dtype": "<f4",
                     "compressor": {"id": "zstd", "level": 1}, **metadata}).write(
            np.arange(4, dtype=metadata.get("dtype", "<f4"))).result()
        with pytest.raises(OrbaxFormatError, match=re.escape(message)):
            OrbaxCheckpoint(path).read()


def test_fixture_reads_without_the_packages():
    """In a process where tensorstore, orbax, zstandard, jax and flax cannot
    be imported, the committed fixture's leaves equal its ``.npz``."""
    code = (
        "import sys\n"
        "for name in ('tensorstore', 'orbax', 'orbax.checkpoint', 'zstandard', 'jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from transkun_tpu_torch.train.checkpoint import load_orbax_checkpoint\n"
        f"tree = load_orbax_checkpoint({FIXTURE!r})\n"
        f"want = np.load({FIXTURE!r} + '.npz')\n"
        "def flat(t, p=''):\n"
        "    items = t.items() if isinstance(t, dict) else enumerate(t) if isinstance(t, list) else None\n"
        "    if items is None:\n"
        "        return [] if t is None else [(p, t)]\n"
        "    return [x for k, v in items for x in flat(v, f'{p}/{k}' if p else str(k))]\n"
        "got = {k: np.asarray(v) for k, v in flat(tree)}\n"
        "assert sorted(got) == sorted(want.files), (len(got), len(want.files))\n"
        "for k in want.files:\n"
        "    assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k\n"
        "    assert got[k].tobytes() == want[k].tobytes(), k\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('tensorstore', 'orbax', 'zstandard', 'jax', 'flax') and sys.modules[m] is not None]\n"
        "print('leaves', len(want.files))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.startswith("leaves ")


def test_fixture_guard_jax_reads_the_npz():
    """JAX ``load_params`` and ``load_checkpoint`` of the committed fixture
    equal its ``.npz``: the fixture is what the JAX package wrote."""
    want = np.load(FIXTURE + ".npz")
    best = dict(_leaves(jax_load_params(FIXTURE, None)))
    assert len(best) == sum(k.startswith("best_params/") for k in want.files) > 50
    for path, leaf in best.items():
        key = "best_params/" + "/".join(str(p.key) for p in path)
        assert np.asarray(leaf).dtype == want[key].dtype and np.asarray(leaf).tobytes() == want[key].tobytes(), key
    tree = jax_load_checkpoint(FIXTURE)
    assert int(tree["step"]) == int(want["step"]) and str(want["extra/warmstart_from"]) == "/some/donor"
    assert int(tree["extra"]["epoch"]) == int(want["extra/epoch"]) == 3
    # the latest params differ from the best
    assert not np.array_equal(tree["params"]["params"]["scorer"]["map"]["kernel"],
                              want["best_params/params/scorer/map/kernel"])


def test_full_width_state_dict_bit_for_bit(tmp_path):
    """JAX ``save_checkpoint`` of a flagship (``2.0.conf``) state with
    seeded float32 weights; the port's ``load_params`` decodes
    ``best_params`` alone, and its state_dict equals ``state_dict_from_flax``
    of JAX ``load_params``, bit for bit."""
    _, jconf = jax_default_conf()
    shapes = jax.eval_shape(lambda k: JaxTransKun(jconf).init(k, n_frames=33), jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    best = jax.tree.map(lambda a: a + np.float32(0.01), params)
    state = init_train_state(params, make_optimizer(params["params"]))
    path = str(tmp_path / "flagship")
    jax_save_checkpoint(path, state, best_params=best, extra={"epoch": 1})
    _, conf = load_default_conf()
    t0 = time.perf_counter()
    got = load_params(path, conf)
    seconds = time.perf_counter() - t0
    want = state_dict_from_flax(jax_load_params(path, jconf), conf)
    assert list(got) == list(want) and sum(v.numel() for v in got.values()) == 13_615_503
    for key, value in want.items():
        assert got[key].dtype == value.dtype == torch.float32
        assert torch.equal(got[key].view(torch.int32), value.view(torch.int32)), key
    print(f"port load_params of the flagship best_params: {seconds:.2f} s")
