#!/usr/bin/env python3
"""Design studies of the blocked cluster kernels (1 Viterbi, 2 alpha, 3
beta) on one CUDA card: what sizes their grid and what a block spends its
time on.

    python3 scripts/study_cluster_dp.py [--sweep] [--phases] [--variants]

``--sweep`` prints the card's count of co-resident clusters of each size
(``cudaOccupancyMaxActiveClusters``, as the wrappers ask it) and the device
time a launch of kernels 1 and 3 at every cluster size from 1 to 16, through
the wrappers (``cluster=``), at ``[696,696,128]`` and ``[696,696,384]``,
fp32 and bf16, beside the size ``launch_plan`` picks.  Then kernel 2 at
``[696,696,384]``, fp32 and bf16, at every cluster size from 1 to 8: as it
is (through the wrapper), built with a row of 64 and of 128 bytes a CTA in
place of its own, with a ring of 4 and of 8 stages in place of 16, with
stages of 64 owned begins in place of 32 (clusters of at most 4), with no
and with 256-byte L2 promotion in place of 128, and, as the yardstick its
TMA ring must beat, the
forward instance of kernel 3's body (each thread loads its far scores into
registers; "step A", sizes 1-16).

``--phases`` builds the Viterbi kernel with ``clock64`` stamps at its
phases and prints the mean cycles a block of each (the far pass; the warp's
merge and the stores to the cluster; the cluster barrier with the next
block's loads issued between its halves; the merge of the CTAs' partials;
the corner) at ``[696,696,128]`` fp32, cluster sizes 1-8; a second build
issues the loads after the barrier, which separates their cost from the
barrier's.  Then the alpha kernel, stamped the same way (its far pass
holding the waits for the TMA ring, which are also counted apart), at
``[696,696,384]`` fp32 and bf16, cluster sizes 1-8.

``--variants`` builds the two kernels from the sources as they are, with
128-byte rows (4 sectors a CTA in place of 1), and with an ``L2::128B`` or
``L2::256B`` prefetch hint on the far loads, and times each at cluster sizes
1-16.

Every build here is held against the plain version (Viterbi bit for bit,
alpha and beta within 1e-5 * max(1, |plain|)); builds go to a temporary
directory.
Prints the card's name and power limit first; exits 1 without a CUDA device.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

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

# the alpha kernel: its row width a CTA (bytes, both score types), and kernel
# 3's body built as the forward table (step A: semicrf_beta.cu's exports run
# the forward instance)
LSE = "semicrf_lse_cluster.cuh"
ALPHA_ROWS = {"64-byte rows": [(LSE, "constexpr int kAlphaRowBytesF32 = 32;", "constexpr int kAlphaRowBytesF32 = 64;"),
                               (LSE, "constexpr int kAlphaRowBytesBF16 = 32;",
                                "constexpr int kAlphaRowBytesBF16 = 64;")],
              # fp32 only: a bf16 row of 128 bytes is 64 lanes, 512 corner threads
              "128-byte rows": [(LSE, "constexpr int kAlphaRowBytesF32 = 32;",
                                 "constexpr int kAlphaRowBytesF32 = 128;")]}
ALPHA_RING = {
    **{f"{n} TMA stages": [(LSE, "constexpr int kAlphaStages = 16;", f"constexpr int kAlphaStages = {n};")]
       for n in (4, 8)},
    **{f"L2 promotion {p}": [("semicrf_alpha.cu", "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                              f"CU_TENSOR_MAP_L2_PROMOTION_{p}")] for p in ("NONE", "L2_256B")},
    # stages of 64 owned begins (4 rows a slot, 8 stages of 16 KB): half the
    # waits a block, but a box traverses 64 C <= 256 begins, so C <= 4
    "64 begins a stage": [
        (LSE, "  static constexpr int kRows = 2 * kSlots;                   // owned begins a stage, 2 a slot",
         "  static constexpr int kRows = 4 * kSlots;"),
        (LSE, "constexpr int kAlphaStages = 16;", "constexpr int kAlphaStages = 8;"),
        (LSE, "constexpr int kAlphaMaxCluster = 8;", "constexpr int kAlphaMaxCluster = 4;"),
        (LSE, "        for (int t = 0; t < 2; ++t) {\n          const int u = slot + A::kSlots * t;",
         "        for (int t = 0; t < 4; ++t) {\n          const int u = slot + A::kSlots * t;")],
}
STEP_A = [("semicrf_beta.cu", "launch_lse_cluster<false, float>", "launch_lse_cluster<true, float>"),
          ("semicrf_beta.cu", "launch_lse_cluster<false, __nv_bfloat16>",
           "launch_lse_cluster<true, __nv_bfloat16>"),
          ("semicrf_beta.cu", "lse_cluster_max_clusters<false>", "lse_cluster_max_clusters<true>")]
# clock64 stamps in the alpha kernel: (file, text as it is, text with a
# stamp, the text after which the patch applies); a consumer's phases are
# recorded by thread 0, the corner's by the first corner thread; the clock
# reads are ordered with the memory operations and barriers around them
ALPHA_KERNEL = "alpha_tma_kernel(const __grid_constant__"
ALPHA_PHASES = ("far pass over the older rows", "waiting for the previous corner",
                "far pass over the previous block's rows", "merge in the warp + stores",
                "cluster barrier", "the corner (on its own warps)")
ALPHA_STAMPS = [
    (LSE, "    const int k0 = n * kBlock;\n    const int owned = owned_below(k0, rank, c);\n    // rows below",
     "    long long t0 = study_clock(), waited = 0;\n"
     "    const int k0 = n * kBlock;\n    const int owned = owned_below(k0, rank, c);\n    // rows below", ALPHA_KERNEL),
    (LSE, "      if (wait) mbar_wait(&full[at], (stage / kAlphaStages) & 1);\n",
     "      long long w0 = study_clock();\n      if (wait) mbar_wait(&full[at], (stage / kAlphaStages) & 1);\n"
     "      waited += study_clock() - w0;\n", ALPHA_KERNEL),
    (LSE, "    if (n > 0) named_sync(kCornerDone, kCornerMeet);",
     "    long long t1 = study_clock();\n    if (n > 0) named_sync(kCornerDone, kCornerMeet);\n"
     "    long long t2 = study_clock();", ALPHA_KERNEL),
    (LSE, "    float2 pair[V];\n", "    long long t3 = study_clock();\n    float2 pair[V];\n", ALPHA_KERNEL),
    (LSE, "    cluster_arrive();\n    cluster_wait();\n  }\n}\n",
     "    long long t4 = study_clock();\n    cluster_arrive();\n    cluster_wait();\n"
     "    long long t5 = study_clock();\n    if (threadIdx.x == 0) {\n"
     "      unsigned long long* d = study_cycles + blockIdx.x * 8;\n"
     "      d[0] += t1 - t0; d[1] += t2 - t1; d[2] += t3 - t2; d[3] += t4 - t3; d[4] += t5 - t4;\n"
     "      d[6] += waited; d[7] += 1;\n    }\n  }\n}\n", ALPHA_KERNEL),
    (LSE, "      cn.template run<G>(parts, tab, out, n, i, cl, tp, nbp, col0 + cl, c, rank, n & 1);\n",
     "      long long c0 = study_clock();\n"
     "      cn.template run<G>(parts, tab, out, n, i, cl, tp, nbp, col0 + cl, c, rank, n & 1);\n"
     "      if (ct == 0) study_cycles[blockIdx.x * 8 + 5] += study_clock() - c0;\n", ALPHA_KERNEL),
    (LSE, '#include "cluster_dp.cuh"\n',
     '#include "cluster_dp.cuh"\n\n__device__ unsigned long long study_cycles[4096 * 8];\n'
     '__device__ __forceinline__ long long study_clock() {\n  long long t;\n'
     '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");\n  return t;\n}\n', None),
    ("semicrf_alpha.cu", 'extern "C" {\n', 'extern "C" {\n\nint study_read(void* host) {\n'
     '  return (int)cudaMemcpyFromSymbol(host, study_cycles, sizeof(study_cycles));\n}\n\n'
     'int study_zero() {\n  static unsigned long long zero[4096 * 8];\n'
     '  return (int)cudaMemcpyToSymbol(study_cycles, zero, sizeof(zero));\n}\n', None),
]


def build(tmp, name, edits, source):
    """Copy ``csrc`` to ``tmp/name``, apply ``edits`` ((file, old, new) or
    (file, old, new, anchor): the first ``old`` after ``anchor``), compile
    ``source``; returns the loaded library."""
    from transkun_tpu_torch.ops import _build

    d = os.path.join(tmp, name.replace(" ", "_").replace(":", ""))
    if not os.path.exists(d):
        shutil.copytree(_build.CSRC_DIR, d)
        for fname, old, new, *anchor in edits:
            path = os.path.join(d, fname)
            text = open(path).read()
            at = text.find(anchor[0]) if anchor and anchor[0] else 0
            if at < 0 or old not in text[at:]:
                raise RuntimeError(f"{name}: {fname} no longer holds {old[:50]!r}")
            with open(path, "w") as f:
                f.write(text[:at] + text[at:].replace(old, new, 1))
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
    """Scores, noise and diagonal of ``kernel`` ("viterbi", "alpha" or
    "beta") at the padded shape of t positions, and the plain version's
    table."""
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
    spdiag = torch.nn.functional.softplus(diag).contiguous()
    if kernel == "alpha":
        args = [s, torch.nn.functional.pad(noise[:-1], (0, 0, 1, 0)).contiguous(), spdiag]
        return args, logz.alpha_table_padded_plain(*args)
    args = [s, noise, spdiag]
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


def sweep_alpha(card, dev, tmp):
    """Kernel 2 at [696,696,384]: as it is, with other rows a CTA, and step A."""
    import torch

    from transkun_tpu_torch.ops import _cluster, logz

    designs = {**{name: ("semicrf_alpha", e) for name, e in {**ALPHA_ROWS, **ALPHA_RING}.items()},
               "step A (kernel 3's body, register loads)": ("semicrf_beta", STEP_A)}
    with ThreadPoolExecutor(len(designs)) as pool:
        libs = dict(zip(designs, pool.map(lambda n: build(tmp, n, designs[n][1], designs[n][0]),
                                          designs)))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        args, want = inputs("alpha", 691, 384, dtype, dev)
        plan = logz.alpha_card_plan(args[0])
        counts = _cluster.card_max_clusters(logz._library("semicrf_alpha").semicrf_alpha_max_clusters,
                                            696, dtype, 0)
        times = []
        for c in _cluster.ALPHA_CLUSTER_SIZES:
            ok = agrees("alpha", logz.alpha_table_padded_cuda(*args, cluster=c), want)
            times.append(f"{c}: {device_ms(lambda: logz.alpha_table_padded_cuda(*args, cluster=c)):.4f}"
                         + ("" if ok else " WRONG"))
        print(f"sweep alpha [696,696,384] {tag} ({card}): as it is ({plan.row_bytes}-byte rows, "
              f"{plan.stages} TMA stages), planned cluster {plan.cluster} ({plan.ctas} CTAs); clusters "
              f"the card holds at once {counts}; ms a launch by cluster size: {'; '.join(times)}",
              flush=True)
        out = torch.empty_like(want)
        for name, (source, _) in designs.items():
            if name == "128-byte rows" and dtype == torch.bfloat16:
                continue
            lanes = (64 if "64" in name else 128 if "128" in name else 32) // args[0].element_size()
            times = []
            for c in (SIZES if source == "semicrf_beta" else _cluster.ALPHA_CLUSTER_SIZES):
                call = launcher(libs[name], source, args, out, c)
                try:
                    call()
                except RuntimeError:  # e.g. more shared memory than a CTA may have
                    times.append(f"{c}: refused")
                    continue
                torch.cuda.synchronize()
                ok = agrees("alpha", out, want)
                times.append(f"{c} ({384 // lanes * c} CTAs): {device_ms(call):.4f}" + ("" if ok else " WRONG"))
            print(f"sweep alpha {name} [696,696,384] {tag} ({card}): ms a launch by cluster size: "
                  f"{'; '.join(times)}", flush=True)
        del args, want, out


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
    alpha_phases(card, dev, tmp, "stamps", ALPHA_STAMPS, range(1, 9))


def alpha_phases(card, dev, tmp, name, edits, sizes):
    """The alpha kernel built with ``edits`` (stamps included): device ms
    and cycles a block by phase, at [696,696,384] fp32 and bf16."""
    import torch

    lib = build(tmp, "alpha " + name, edits, "semicrf_alpha")
    lib.study_read.argtypes = [ctypes.c_void_p]
    for dtype in (torch.float32, torch.bfloat16):
        args, want = inputs("alpha", 691, 384, dtype, dev)
        out = torch.empty_like(want)
        groups = 384 // (32 // args[0].element_size())
        for c in sizes:
            call = launcher(lib, "semicrf_alpha", args, out, c)
            call()
            torch.cuda.synchronize()
            ok = agrees("alpha", out, want)
            lib.study_zero()
            ms = device_ms(call)
            cycles = np.zeros(4096 * 8, np.uint64)
            lib.study_read(cycles.ctypes.data)
            cycles = cycles.reshape(-1, 8)[: groups * c].astype(np.float64)
            per_block = cycles[:, :7].sum(0) / cycles[:, 7].sum()
            print(f"phases alpha ({name}) [696,696,384] {str(dtype)[6:]} cluster {c} ({card}): {ms:.4f} ms"
                  f"{'' if ok else ' WRONG'}; cycles a block: "
                  + ", ".join(f"{p} {x:.0f}" for p, x in zip(ALPHA_PHASES, per_block))
                  + f" (of the far pass, waiting for the ring {per_block[6]:.0f}); "
                  f"a block {ms * 1e-3 / -(-691 // 8) * 1e9:.0f} ns", flush=True)
        del args, want, out


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
            sweep_alpha(card, dev, tmp)
        if args.phases:
            phases(card, dev, tmp)
        if args.variants:
            variants(card, dev, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
