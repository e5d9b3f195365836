#!/usr/bin/env python3
"""Design study of the walk kernel (``csrc/decode_walk.cu``, kernel 9) on
one CUDA card: where a group's time goes, and which tile of tracks a CTA
should take.

    python3 scripts/study_walk.py [--parent DIR] [--runs 5]

On the first group of ``chip_smoke.py``'s path 1 (its 64 s piece, the
flagship V2 configuration with the same seeded weights: 4 segments, t =
691, 90 tracks, k_max 128):

* the device time a launch (``torch.profiler``, over 20 launches) and the
  time a launch back to back between CUDA events (which the wrapper's host
  work sets where it is the slower), through the wrapper at each tile the
  kernel takes (1-32 tracks a CTA, set as ``walk.TILE``), each checked
  against ``walk_group_plain``;
* the kernel built with ``-DDECODE_WALK_PHASES`` (``clock64`` marks; the
  port's build has none), at tiles 1, 2, 4 and 8: the mean cycles a CTA's
  walker warp spends waiting for rows and free buffers, walking (until its
  last walker is done) and in all, and its first stager spends issuing the
  first copies, waiting for walks, refilling the ring and flushing; the
  walker warp's chain steps (each segment's longest walk, summed), the
  cycles a step and those of them in the chain's loop (the rest is each
  segment's set-up and tail), and the first four segments' walks one by
  one; then at tile 4 built so that the walk waits for every segment's
  rows ("rows first"), which shows a step's cost with no copies beside it;
* with ``--parent DIR`` (a checkout of an earlier commit whose kernel is
  the first version: one thread a track, the tables read from global
  memory), that kernel built with ``clock64`` marks patched into a copy of
  its source and launched through ``parent_walk``: the cycles a
  warp spends walking, its chain steps, and the cycles from issuing a
  step's ptr and diag loads to their first use.

Cycles convert to ns at the SM clock that ``nvidia-smi`` reads after the
runs.  Prints the card's name and power limit first; exits 1 without a
CUDA device.
"""

import argparse
import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402  (the path 1 inputs, the profiler's time)
LAUNCHES = 20
TILES = (1, 2, 4, 8, 16, 32)
PHASE_TILES = (1, 2, 4, 8)
# the phase marks of csrc/decode_walk.cu: warp 0's, then the first stager's
WALKER_PHASES = ("waiting for rows and buffers", "walking", "in all")
STAGER_PHASES = ("issuing the first copies", "waiting for walks", "refilling the ring", "flushing")
N_PHASES, PHASE_BLOCKS = 18, 4096
# the "rows first" build: the walk waits for every segment's rows (the plan
# stages all n segments at the study's shape)
ROWS_WAIT = "      if (kStaged) mbar_wait(&full[s % ring_slots], (s / ring_slots) & 1);"
ROWS_FIRST = "      if (kStaged) for (int q = 0; q < slots; ++q) mbar_wait(&full[q], 0);"

# clock64 marks in the kernel's first version: (text as it is, text with the marks)
PARENT_STAMPS = [
    ("  if (b >= p) return;\n",
     "  const unsigned live = __ballot_sync(0xffffffffu, b < p);\n  if (b >= p) return;\n"
     "  long long c0 = study_clock(), lat = 0; int warp_steps = 0;\n"),
    ("    int j = start;\n    while (j < t - 1) {\n      const int sel = ptr_s[(size_t)j * p];\n"
     "      if (diag_s[(size_t)j * p]) emit(j, j);\n",
     "    int j = start, steps = 0;\n    while (j < t - 1) {\n      ++steps;\n"
     "      long long l0 = study_clock();\n      const int sel = ptr_s[(size_t)j * p];\n"
     "      const int d_ = diag_s[(size_t)j * p];\n      study_sink = sel + d_;\n"
     "      lat += study_clock() - l0;\n      if (d_) emit(j, j);\n"),
    ("    if (j == t - 1 && diag_s[(size_t)(t - 1) * p]) emit(t - 1, t - 1);\n",
     "    if (j == t - 1 && diag_s[(size_t)(t - 1) * p]) emit(t - 1, t - 1);\n"
     "    warp_steps += __reduce_max_sync(live, steps);\n"),
    ("  start_out[b] = start;\n",
     "  start_out[b] = start;\n  __syncwarp(live);\n  const long long c1 = study_clock();\n"
     "  const unsigned long long lat_max = __reduce_max_sync(live, (unsigned)lat);\n"
     "  if ((threadIdx.x & 31) == 0) {\n    unsigned long long* d = study_cycles + (blockIdx.x * 4 + threadIdx.x / 32) * 4;\n"
     "    d[0] += c1 - c0; d[1] += warp_steps; d[2] += lat_max; d[3] += 1;\n  }\n"),
    ("namespace {\n",
     "__device__ unsigned long long study_cycles[64 * 4];\n__shared__ volatile int study_sink;\n"
     "__device__ __forceinline__ long long study_clock() {\n  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t)::\"memory\");\n  return t;\n}\n\nnamespace {\n"),
    ('extern "C" {\n',
     'extern "C" {\n\nint study_read(void* host) {\n'
     '  return (int)cudaMemcpyFromSymbol(host, study_cycles, sizeof(study_cycles));\n}\n\n'
     'int study_zero() {\n  static unsigned long long zero[64 * 4];\n'
     '  return (int)cudaMemcpyToSymbol(study_cycles, zero, sizeof(zero));\n}\n'),
]


def nvcc(source, out, defines=()):
    from transkun_tpu_torch.ops import _build

    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o", out, source],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(out)


def parent_walk(source, tmp, dev):
    """The first version of the walk kernel (one thread a track; its C
    interface takes no plan and its wrapper zero-fills begins and ends),
    from ``source`` (another checkout's ``csrc/decode_walk.cu``), built into
    ``tmp``; returns the library and a function with ``walk_group_cuda``'s
    first arguments that does what that wrapper did.  Raises for a later
    version, whose C interface differs."""
    import torch

    lib = nvcc(source, os.path.join(tmp, "libdecode_walk_parent.so"))
    if hasattr(lib, "decode_walk_smem_bytes"):
        raise RuntimeError(f"{source} is not the walk kernel's first version: its C interface takes a "
                           f"launch plan")
    lib.decode_walk.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.decode_walk.restype = ctypes.c_int

    def call(ptr, diag, bpres, start, k_max, last_frame_idx, step_frames, onset_bound=-1):
        n, t, p = diag.shape
        begins = torch.zeros(n, p, k_max, dtype=torch.int32, device=dev)
        ends = torch.zeros_like(begins)
        count = torch.empty(n, p, dtype=torch.int32, device=dev)
        overflow = torch.empty(n, p, dtype=torch.bool, device=dev)
        start_out = torch.empty(p, dtype=torch.int32, device=dev)
        err = lib.decode_walk(
            ptr.data_ptr(), diag.data_ptr(), bpres.data_ptr(), start.data_ptr(), begins.data_ptr(),
            ends.data_ptr(), count.data_ptr(), overflow.data_ptr(), start_out.data_ptr(), n, t, p,
            bpres.shape[-1], k_max, last_frame_idx, step_frames, onset_bound, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"the parent's decode_walk launch failed ({err})")
        return begins, ends, count, overflow, start_out

    return lib, call


def real_tables(dev):
    """Group 0's ptr, diag and bpres of chip_smoke.py's path 1, its start,
    and the chain's geometry (k_max, last_frame_idx, step_frames)."""
    import torch

    from transkun_tpu_torch.models.config import load_default_conf
    from transkun_tpu_torch.models.transkun import DEFAULT_SEGMENT_BATCH, TransKun

    _, conf = load_default_conf()
    model = TransKun(conf, device=dev, seed=chip_smoke.SEED)
    with torch.no_grad():
        model.module.scorer.map[0].bias[-1] = -8.0
    audio = chip_smoke.synth_piece(conf.fs, chip_smoke.PIECE_SECONDS, chip_smoke.SEED)
    pad = math.ceil((conf.segmentSizeInSecond - conf.segmentHopSizeInSecond) * conf.fs)
    step = math.ceil(conf.segmentHopSizeInSecond * conf.fs / conf.hopSize) * conf.hopSize
    seg_size = math.ceil(conf.segmentSizeInSecond * conf.fs)
    lfi = round(seg_size / conf.hopSize)
    start0 = math.floor((conf.segmentSizeInSecond - conf.segmentHopSizeInSecond) * conf.fs / conf.hopSize)
    audio_dev = torch.from_numpy(np.pad(audio.T, ((0, 0), (pad, pad + seg_size)))).to(dev)
    with torch.no_grad():
        ptr, diag, bpres, _ = model._group_tables(
            audio_dev, [step * i for i in range(DEFAULT_SEGMENT_BATCH)], seg_size, lfi)
    start = torch.full((90,), start0, dtype=torch.int32, device=dev)
    return (ptr, diag, bpres, start), (model.decode_k_max, lfi, step // conf.hopSize)


def device_ms(call, runs):
    """(device milliseconds a call: ``chip_smoke.profiled_ms`` over LAUNCHES
    calls, which raises where the profiler saw no device time; and the
    median milliseconds a call of ``runs`` runs of LAUNCHES calls between
    two CUDA events, which the host's enqueue sets where it is the
    slower)."""
    import torch

    device = chip_smoke.profiled_ms(call, LAUNCHES)
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(LAUNCHES):
            call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / LAUNCHES)
    return device, float(np.median(times))


def phases_launcher(lib, args, geometry):
    """A launch of the phases build with ``launch_plan``'s plan at
    ``walk.TILE``, as ``walk_group_cuda`` makes it."""
    import torch

    from transkun_tpu_torch.ops import walk

    ptr, diag, bpres, start = args
    n, t, p = diag.shape
    k_max, lfi, step_frames = geometry
    plan = walk.launch_plan(n, t, p, k_max, bpres.shape[-1])
    outs = [torch.empty(n, p, k_max, dtype=torch.int32, device=ptr.device) for _ in range(2)]
    outs += [torch.empty(n, p, dtype=torch.int32, device=ptr.device),
             torch.empty(n, p, dtype=torch.bool, device=ptr.device),
             torch.empty(p, dtype=torch.int32, device=ptr.device)]

    def call():
        err = lib.decode_walk(*(a.data_ptr() for a in (*args, *outs)), n, t, p, bpres.shape[-1], k_max, lfi,
                              step_frames, -1, plan.tile.bit_length() - 1, plan.slots, int(plan.buffered),
                              ptr.device.index, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_walk (phases) launch failed ({err})")
        return outs
    return call, plan


def phases(lib, label, args, geometry, want, card, runs):
    """Time a phases build at ``walk.TILE`` and print its mean cycles a CTA
    by phase, its chain steps and cycles a step, and each of the first four
    segments' walk."""
    import torch

    call, plan = phases_launcher(lib, args, geometry)
    ok = all(torch.equal(g.cpu(), w) for g, w in zip(call(), want))
    ms = device_ms(call, runs)[0]
    lib.decode_walk_phases_zero()
    for _ in range(LAUNCHES):
        call()
    torch.cuda.synchronize()
    cycles = np.zeros(PHASE_BLOCKS * N_PHASES, np.uint64)
    lib.decode_walk_phases_read(cycles.ctypes.data)
    cycles = cycles.reshape(-1, N_PHASES)[: plan.blocks].astype(np.float64)
    per_cta = cycles.sum(0) / cycles[:, 8].sum()
    steps = per_cta[7]
    mhz = sm_clock_mhz()
    by_segment = [f"{per_cta[9 + s]:.0f} for {per_cta[13 + s]:.1f}" for s in range(4)]
    print(f"phases ({label}) ({card}, SM clock {mhz[0]:.0f} of {mhz[1]:.0f} MHz): device {ms:.4f} ms "
          f"(marks built in){'' if ok else ' WRONG'}; mean cycles a CTA, walker warp: "
          + ", ".join(f"{name} {x:.0f}" for name, x in zip(WALKER_PHASES, per_cta[:3]))
          + "; first stager: "
          + ", ".join(f"{name} {x:.0f}" for name, x in zip(STAGER_PHASES, per_cta[3:7]))
          + f"; walker warp's chain steps {steps:.1f}, {per_cta[1] / steps:.1f} cycles "
          f"({per_cta[1] / steps / mhz[0] * 1e3:.1f} ns) a step, of them in the chain's loop "
          f"{per_cta[17] / steps:.1f}; by segment, cycles walking for steps "
          f"{by_segment}; slowest CTA in all {(cycles[:, 2] / cycles[:, 8]).max():.0f} cycles", flush=True)


def sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return [float(x) for x in out.split(",")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit (the walk kernel's first version)")
    ap.add_argument("--runs", type=int, default=5)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("study_walk: no CUDA device", file=sys.stderr)
        return 1
    from transkun_tpu_torch.ops import _build, walk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    args, geometry = real_tables(dev)
    want = walk.walk_group_plain(*(a.cpu() for a in args), *geometry)
    n, t, p = args[1].shape
    tile_default = walk.TILE
    print(f"group 0 of path 1: n={n}, t={t}, P={p}, k_max={geometry[0]}; {int(want[2].sum())} events; "
          f"planned {walk.launch_plan(n, t, p, geometry[0])}", flush=True)

    # every tile through the wrapper
    for tile in TILES:
        walk.TILE = tile
        got = walk.walk_group_cuda(*args, *geometry)
        ok = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        dev_ms, ev_ms = device_ms(lambda: walk.walk_group_cuda(*args, *geometry), opts.runs)
        plan = walk.launch_plan(n, t, p, geometry[0], args[2].shape[-1])
        print(f"tile {tile} ({card}): device {dev_ms:.4f} ms a launch (profiler), {ev_ms:.4f} ms a launch "
              f"back to back over {LAUNCHES}{'' if ok else ' WRONG'}; {plan.blocks} CTAs, {plan.slots} "
              f"segments staged, {plan.smem} bytes", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # this kernel's phases, as it is and with the walk held until every
        # segment's rows have landed (the step's own cost, no copies beside it)
        builds = {"as is": [], "rows first": [(ROWS_WAIT, ROWS_FIRST)]}
        for name, edits in builds.items():
            d = os.path.join(tmp, name.replace(" ", "_"))
            shutil.copytree(_build.CSRC_DIR, d)
            path = os.path.join(d, "decode_walk.cu")
            text = open(path).read()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"decode_walk.cu no longer holds {old[:50]!r}")
                text = text.replace(old, new, 1)
            with open(path, "w") as f:
                f.write(text)
            lib = nvcc(path, os.path.join(d, "libwalk_phases.so"), ("-DDECODE_WALK_PHASES",))
            lib.decode_walk.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
            lib.decode_walk_phases_read.argtypes = [ctypes.c_void_p]
            for tile in PHASE_TILES if name == "as is" else (4,):  # where all segments are staged
                walk.TILE = tile
                phases(lib, f"{name}, tile {tile}", args, geometry, want, card, opts.runs)
        walk.TILE = tile_default

        if opts.parent:
            src = os.path.join(opts.parent, "transkun_tpu_torch", "csrc", "decode_walk.cu")
            text = open(src).read()
            for old, new in PARENT_STAMPS:
                if old not in text:
                    raise RuntimeError(f"the parent's decode_walk.cu no longer holds {old[:50]!r}")
                text = text.replace(old, new, 1)
            path = os.path.join(tmp, "decode_walk_parent.cu")
            with open(path, "w") as f:
                f.write(text)
            plib, parent_launch = parent_walk(path, tmp, dev)
            plib.study_read.argtypes = [ctypes.c_void_p]

            def parent_call():
                return parent_launch(*args, *geometry)

            ok = all(torch.equal(g.cpu(), w) for g, w in zip(parent_call(), want))
            ms = device_ms(parent_call, opts.runs)[0]
            plib.study_zero()
            for _ in range(LAUNCHES):
                parent_call()
            torch.cuda.synchronize()
            cycles = np.zeros(64 * 4, np.uint64)
            plib.study_read(cycles.ctypes.data)
            cycles = cycles.reshape(-1, 4)[:3].astype(np.float64)  # the warps of the 90 tracks
            runs = cycles[:, 3:4]
            walk_c, steps, lat = (cycles[:, i] / runs[:, 0] for i in range(3))
            mhz = sm_clock_mhz()
            print(f"parent phases ({card}, SM clock {mhz[0]:.0f} of {mhz[1]:.0f} MHz): device {ms:.4f} ms with "
                  f"its two memsets (marks built in){'' if ok else ' WRONG'}; by warp of tracks 0-31, 32-63, "
                  f"64-89: walking {[round(float(x)) for x in walk_c]} cycles, chain steps "
                  f"{[round(float(x), 1) for x in steps]}, {[round(float(x)) for x in walk_c / steps]} cycles "
                  f"a step, of which the ptr and diag loads to their use (the slowest lane's sum) "
                  f"{[round(float(x)) for x in lat / steps]}; a step "
                  f"{float((walk_c / steps).max()) / mhz[0] * 1e3:.0f} ns", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
