#!/usr/bin/env python3
"""Design studies of the blocked cluster kernels (1 Viterbi, 3 beta) on one
CUDA card: what sizes their grid and what a block spends its time on.

    python3 scripts/study_cluster_dp.py [--sweep] [--phases] [--variants]

``--sweep`` prints the card's count of co-resident clusters of each size
(``cudaOccupancyMaxActiveClusters``, as the wrappers ask it) and the device
time a launch of kernels 1 and 3 at every cluster size from 1 to 16, through
the wrappers (``cluster=``), at ``[696,696,128]`` and ``[696,696,384]``,
fp32 and bf16, beside the size ``launch_plan`` picks.

``--phases`` builds the Viterbi kernel with ``clock64`` stamps at its
phases and prints the mean cycles a block of each (the far pass; the warp's
merge and the stores to the cluster; the cluster barrier with the next
block's loads issued between its halves; the merge of the CTAs' partials;
the corner) at ``[696,696,128]`` fp32, cluster sizes 1-8; a second build
issues the loads after the barrier, which separates their cost from the
barrier's.

``--variants`` builds the two kernels from the sources as they are, with
128-byte rows (4 sectors a CTA in place of 1), and with an ``L2::128B`` or
``L2::256B`` prefetch hint on the far loads, and times each at cluster sizes
1-16.

Every build here is held against the plain version (Viterbi bit for bit,
beta within 1e-5 * max(1, |plain|)); builds go to a temporary directory.
Prints the card's name and power limit first; exits 1 without a CUDA device.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
NEG = -1e30
SIZES = range(1, 17)
RUNS = 10  # launches between two events

# source edits of the studies: (file, text as it is, text of the variant)
LOAD = "if (r0 + r < count) buf[r] = __ldg(reinterpret_cast<const uint4*>(piece(r0 + r)));"
HINTED = ("if (r0 + r < count) {{ const void* a_ = piece(r0 + r); uint4 v_; asm volatile("
          "\"ld.global.nc.L2::{}B.v4.u32 {{%0,%1,%2,%3}}, [%4];\" : \"=r\"(v_.x), \"=r\"(v_.y), "
          "\"=r\"(v_.z), \"=r\"(v_.w) : \"l\"(a_)); buf[r] = v_; }}")
VARIANTS = {
    "as is": [],
    "128-byte rows": [("cluster_dp.cuh", "constexpr int kRowBytes = 32;", "constexpr int kRowBytes = 128;")],
    "L2::128B": [("cluster_dp.cuh", LOAD, HINTED.format(128))],
    "L2::256B": [("cluster_dp.cuh", LOAD, HINTED.format(256))],
}
ROW_BYTES = {"128-byte rows": 128}
NEXT_LOADS = """    if (n + 1 < nb) {  // the next block's scores, while this block finishes
      const int next = pieces_of_slot(owned_below(k0 + kBlock, rank, c), slot);
      load_pieces(buf, 0, next, [&](int t) { return piece(n + 1, t); });
    }
"""
STAMPS = [  # (text as it is, text with a stamp before or after it)
    ("    const int k0 = n * kBlock;\n    const int count = pieces_of_slot(",
     "    long long t0 = clock64();\n    const int k0 = n * kBlock;\n    const int count = pieces_of_slot("),
    ("    // the slots of the warp meet;", "    long long t1 = clock64();\n    // the slots of the warp meet;"),
    ("    cluster_arrive();\n", "    long long t2 = clock64();\n    cluster_arrive();\n"),
    ("    cluster_wait();\n", "    cluster_wait();\n    long long t3 = clock64();\n"),
    ("    // -- corner:", "    long long t4 = clock64();\n    // -- corner:"),
    ("    __syncthreads();\n  }\n}",
     "    __syncthreads();\n    long long t5 = clock64();\n    if (threadIdx.x == 0) {\n"
     "      unsigned long long* d = study_cycles + blockIdx.x * 6;\n"
     "      d[0] += t1 - t0; d[1] += t2 - t1; d[2] += t3 - t2; d[3] += t4 - t3; d[4] += t5 - t4; d[5] += 1;\n"
     "    }\n  }\n}"),
    ('#include "cluster_dp.cuh"\n', '#include "cluster_dp.cuh"\n\n__device__ unsigned long long study_cycles[4096 * 6];\n'),
    ('extern "C" {\n', 'extern "C" {\n\nint study_read(void* host) {\n'
     '  return (int)cudaMemcpyFromSymbol(host, study_cycles, sizeof(study_cycles));\n}\n\n'
     'int study_zero() {\n  static unsigned long long zero[4096 * 6];\n'
     '  return (int)cudaMemcpyToSymbol(study_cycles, zero, sizeof(zero));\n}\n'),
]
PHASES = ("far pass", "merge in the warp + stores", "cluster barrier", "merge of the CTAs", "corner")


def build(tmp, name, edits, source):
    """Copy ``csrc`` to ``tmp/name``, apply ``edits``, compile ``source``;
    returns the loaded library."""
    from transkun_tpu_torch.ops import _build

    d = os.path.join(tmp, name.replace(" ", "_").replace(":", ""))
    if not os.path.exists(d):
        shutil.copytree(_build.CSRC_DIR, d)
        for fname, old, new in edits:
            path = os.path.join(d, fname)
            text = open(path).read()
            if old not in text:
                raise RuntimeError(f"{name}: {fname} no longer holds {old[:50]!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
    out = os.path.join(d, f"lib{source}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                           os.path.join(d, source + ".cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name} {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    for fn in (source, source + "_bf16"):
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


def inputs(kernel, t, nbp, dtype, dev):
    """Scores, noise and diagonal of ``kernel`` ("viterbi" or "beta") at the
    padded shape of t positions, and the plain version's table."""
    import torch

    from transkun_tpu_torch.ops import logz, viterbi

    gen = torch.Generator(device=dev).manual_seed(t * nbp)
    tp = -(-t // 8) * 8
    s = torch.full((tp, tp, nbp), NEG, device=dev)
    s[:t, :t] = torch.randn(t, t, nbp, generator=gen, device=dev)
    noise = torch.zeros(tp, nbp, device=dev)
    noise[: t - 1] = torch.randn(t - 1, nbp, generator=gen, device=dev) * 0.1
    s = s.to(dtype)
    diag = torch.diagonal(s).t().float().contiguous()
    if kernel == "viterbi":
        args = [s, noise, diag * (diag > 0)]
        return args, viterbi.viterbi_backward_tables_plain(*args)
    args = [s, noise, torch.nn.functional.softplus(diag).contiguous()]
    return args, logz.beta_table_padded_plain(*args)


def agrees(kernel, got, want):
    import torch

    if kernel == "viterbi":
        return torch.equal(got, want)
    return bool(((got - want).abs() <= 1e-5 * want.abs().clamp(min=1.0)).all())


def device_ms(call):
    """Device milliseconds a launch over RUNS launches, after a warm-up."""
    import torch

    call()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(RUNS):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / RUNS


def launcher(lib, source, args, out, cluster):
    import torch

    fn = getattr(lib, source + ("_bf16" if args[0].dtype == torch.bfloat16 else ""))
    tp, _, nbp = args[0].shape

    def call():
        err = fn(*(a.data_ptr() for a in args), out.data_ptr(), tp, nbp, cluster, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{source} launch failed ({err}) at cluster {cluster}")
    return call


def sweep(card, dev):
    import torch

    from transkun_tpu_torch.ops import _cluster, logz, viterbi

    for kernel, fn, plan_of, query in (
            ("viterbi", viterbi.viterbi_backward_tables_cuda, viterbi.card_plan,
             lambda: viterbi._library().viterbi_bwd_max_clusters),
            ("beta", logz.beta_table_padded_cuda, logz.beta_card_plan,
             lambda: logz._library("semicrf_beta").semicrf_beta_max_clusters)):
        for nbp in (128, 384):
            for dtype in (torch.float32, torch.bfloat16):
                args, want = inputs(kernel, 691, nbp, dtype, dev)
                plan = plan_of(args[0])
                counts = _cluster.card_max_clusters(query(), 696, dtype, 0)
                times = []
                for c in SIZES:
                    ok = agrees(kernel, fn(*args, cluster=c), want)
                    times.append(f"{c}: {device_ms(lambda: fn(*args, cluster=c)):.4f}"
                                 + ("" if ok else " WRONG"))
                print(f"sweep {kernel} [696,696,{nbp}] {str(dtype)[6:]} ({card}): planned cluster "
                      f"{plan.cluster} ({plan.ctas} CTAs); clusters the card holds at once {counts}; "
                      f"ms a launch by cluster size: {'; '.join(times)}", flush=True)


def phases(card, dev, tmp):
    import torch

    edits = [("viterbi_bwd.cu", old, new) for old, new in STAMPS]
    late = edits + [("viterbi_bwd.cu", NEXT_LOADS, ""),  # the loads' issue joins the CTAs' merge
                    ("viterbi_bwd.cu", "    long long t3 = clock64();\n",
                     "    long long t3 = clock64();\n" + NEXT_LOADS)]
    args, want = inputs("viterbi", 691, 128, torch.float32, dev)
    for name, e in (("stamps", edits), ("stamps, loads after the barrier", late)):
        lib = build(tmp, name, e, "viterbi_bwd")
        lib.study_read.argtypes = [ctypes.c_void_p]
        out = torch.empty(696, 128, dtype=torch.int32, device=dev)
        for c in range(1, 9):
            call = launcher(lib, "viterbi_bwd", args, out, c)
            call()
            torch.cuda.synchronize()
            ok = torch.equal(out, want)
            lib.study_zero()
            ms = device_ms(call)
            cycles = np.zeros(4096 * 6, np.uint64)
            lib.study_read(cycles.ctypes.data)
            cycles = cycles.reshape(-1, 6)[: 16 * c].astype(np.float64)
            per_block = cycles[:, :5].sum(0) / cycles[:, 5].sum()
            print(f"phases ({name}) viterbi [696,696,128] float32 cluster {c} ({card}): {ms:.4f} ms"
                  f"{'' if ok else ' WRONG'}; cycles a block: "
                  + ", ".join(f"{p} {x:.0f}" for p, x in zip(PHASES, per_block)), flush=True)


def variants(card, dev, tmp):
    import torch

    for source, kernel, out_dtype in (("viterbi_bwd", "viterbi", torch.int32),
                                      ("semicrf_beta", "beta", torch.float32)):
        libs = {name: build(tmp, name, e, source) for name, e in VARIANTS.items()}
        for nbp in (128, 384):
            for dtype in (torch.float32, torch.bfloat16):
                args, want = inputs(kernel, 691, nbp, dtype, dev)
                for name, lib in libs.items():
                    lanes = ROW_BYTES.get(name, 32) // args[0].element_size()
                    out = torch.empty(want.shape, dtype=out_dtype, device=dev)
                    times = []
                    for c in SIZES:
                        call = launcher(lib, source, args, out, c)
                        call()
                        torch.cuda.synchronize()
                        ok = agrees(kernel, out, want)
                        times.append(f"{c} ({nbp // lanes * c} CTAs): {device_ms(call):.4f}"
                                     + ("" if ok else " WRONG"))
                    print(f"variant {name} {kernel} [696,696,{nbp}] {str(dtype)[6:]} ({card}): "
                          f"ms a launch by cluster size: {'; '.join(times)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("study_cluster_dp: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        if args.sweep:
            sweep(card, dev)
        if args.phases:
            phases(card, dev, tmp)
        if args.variants:
            variants(card, dev, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
