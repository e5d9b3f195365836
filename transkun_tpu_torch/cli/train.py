"""Training CLI of the port (counterpart of ``transkun_tpu/cli/train.py`` and
the reference ``python3 -m transkun.train``):

    python -m transkun_tpu_torch.cli.train ckpt.pt \
        --datasetPath ... --datasetMetaFile_train train.pickle \
        --datasetMetaFile_val val.pickle --modelConf conf.json [--device cpu]

Loader -> label encoding -> semi-CRF NLL + attribute NLLs -> backward ->
quantile clip -> rectified AdaBelief, with a stats decode every
``--statsEvery`` steps, validation every ``--validateEvery`` epochs and a
crash-safe checkpoint file.  The data modules are the port's own
``data`` package.  fp32 unless ``--bf16`` (bfloat16 activations; parameters,
loss, gradients, clip and optimizer stay fp32, and so do the checkpoints);
TF32 is turned off for matmuls and convolutions.  The default device is
``cuda`` and the command fails when CUDA is absent; ``--device cpu`` runs
the plain PyTorch versions of the kernels.

The training audio takes one of two routes, as in the JAX trainer:

- ``--deviceData`` (``auto``, the default, ``on``, ``off``): the whole
  corpus packed once as int16 on the device (``data.device_dataset``), each
  step's chunks sliced there; the loader then reads no audio.  ``auto``
  takes it unless ``--augment`` is set (host DSP), and falls back to the host
  loader, saying why, when the corpus is past the size guard or does not fit
  the device's memory; ``on`` raises instead.
- the host loader, whose audio crosses as ``--linkInt16`` says: ``auto``
  int16 when the batch is exactly int16 / 32767 (un-augmented wav audio
  is), ``force`` rounded and clipped to int16, ``off`` float32.

All three give the same frames bit for bit on un-augmented audio: the device
divides int16 by 32767 exactly as the host slicer does.

Data parallelism, one process a rank (``train.step``: gradients and loss
summed over the ranks, not averaged):

- ``--nDevices N`` on one node spawns N ranks (``torch.multiprocessing``),
  one a card over NCCL; with ``--device cpu``, N ranks over gloo.  Fewer
  cards than N is an error.
- under ``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) the process joins the
  launcher's group; ``--nDevices``, if given, must equal ``WORLD_SIZE``.

``--batchSize`` is a rank's batch; the global batch is ``batchSize * N``.
The run seed is rank 0's, rank 0's weights are broadcast, each rank loads
its shard of the epoch's chunks, the label capacity K grows alike on every
rank, each rank validates its shard and the counts are summed; rank 0 alone
prints, saves (a barrier after each save) and writes the TensorBoard log
(``tensorboardX``, ``ckpt + ".log"``, the JAX package's tags).

Resuming (``train.checkpoint.resolve_checkpoint``): a checkpoint at
``saved_filename`` is continued.  A port checkpoint file is resumed and
overwritten in place.  The JAX package's orbax checkpoint directory (its
trainer's ``saved_filename``) is resumed from as the JAX trainer resumes
it: params, AdaBelief's moments and count, the clip ring, the step, the
best params, the loss tracker, the epoch and the run seed, so the step
count, the learning-rate schedule and the data stream carry on.  The
directory is never written: the port saves to ``saved_filename + ".pt"``,
which a later restart resumes from.  Dropout cannot continue the JAX run's
stream: JAX draws it with ``jax.random``, the port with torch generators
seeded by ``train.step.dropout_seed``, a difference kept on purpose.

Timing (``utils.profiling``): with ``TRANSKUN_TPU_TIMING`` set, or under a
``torch.profiler``, the loop records its spans, each a root keyed by the
global step: ``transkun.input`` (the loader's next batch, then
``transkun.slice``, ``transkun.frames``, ``transkun.labels`` and the step's
generator), ``transkun.step`` (``train.step``), ``transkun.fetch`` (the
metric fetch's copy to the host), ``transkun.stats`` (both stats passes) and
``transkun.ckpt`` (a save), and counts ``steps``, ``fetches`` and
``stats_passes``.  Set to anything but ``silent``, rank 0 prints after each
metric fetch each phase's mean host milliseconds a step since the last such
line: ``[train] input .. step .. (forward .. backward .. clip .. optimizer
..) fetch .. stats .. ms a step``.

``main`` returns a record of the run (rank 0's where several ranks ran:
losses, per-step seconds of the step alone and of the whole iteration
(loader wait, upload, frames, labels and step), the largest per-step device
memory, the seconds of each stats pass, the counts of steps, stats passes and
validation batches, and the audio route: ``device_data``,
``device_data_bytes``, ``link_dtype``) for callers that drive it from
Python.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None):
    parser = argparse.ArgumentParser("Perform Training (PyTorch port)")
    parser.add_argument("saved_filename",
                        help="checkpoint file; or the JAX trainer's checkpoint directory, which is "
                        "resumed and left as it is (the port saves to saved_filename.pt)")
    parser.add_argument("--datasetPath", required=True)
    parser.add_argument("--datasetMetaFile_train", required=True)
    parser.add_argument("--datasetMetaFile_val", required=True)
    parser.add_argument("--batchSize", default=4, type=int)
    parser.add_argument("--hopSize", required=False, type=float)
    parser.add_argument("--chunkSize", required=False, type=float)
    parser.add_argument("--gradClippingQuantile", default=0.8, type=float)
    parser.add_argument("--max_lr", default=2e-4, type=float)
    parser.add_argument("--weight_decay", default=1e-4, type=float)
    parser.add_argument("--nIter", default=180000, type=int)
    parser.add_argument("--modelConf", required=True)
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--noiseFolder", required=False)
    parser.add_argument("--irFolder", required=False)
    parser.add_argument("--maxEpoch", default=1000000, type=int)
    parser.add_argument("--maxEvents", default=32, type=int,
                        help="per-track padded event capacity per chunk")
    parser.add_argument("--statsEvery", default=40, type=int,
                        help="decode-and-score a train batch every N steps; 0 disables it")
    parser.add_argument("--validateEvery", default=1, type=int,
                        help="validate every N epochs; the latest checkpoint is saved every epoch")
    parser.add_argument("--warmupCutoff", default=500, type=int,
                        help="steps before the OneCycle schedule starts")
    parser.add_argument("--ckptEvery", default=2000, type=int)
    parser.add_argument("--dataLoaderWorkers", default=4, type=int, help="host loader threads")
    parser.add_argument("--gradientCheckpoint", default="auto", choices=["auto", "on", "off"],
                        help="recompute encoder layers in the backward pass; 'auto' follows "
                        "the conf (useGradientCheckpoint)")
    parser.add_argument("--seed", default=None, type=int,
                        help="run seed (data stream + dropout); default: wall clock.  A resumed "
                        "run reuses the seed in the checkpoint")
    parser.add_argument("--logEvery", default=8, type=int,
                        help="fetch and print train metrics every N steps (each fetch waits "
                        "for the device)")
    parser.add_argument("--stopAtStep", default=None, type=int,
                        help="stop after this many global steps, saving a checkpoint first")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 activations (params stay fp32)")
    parser.add_argument("--nDevices", default=None, type=int,
                        help="data-parallel ranks: without a launcher, spawn this many (one a "
                        "card, or gloo ranks with --device cpu); under torchrun it must equal "
                        "WORLD_SIZE")
    parser.add_argument("--deviceData", default="auto", choices=["auto", "on", "off"],
                        help="pack the training corpus onto the device once (int16) and slice "
                        "each step's chunks there; 'auto' does so without --augment when it fits, "
                        "else uses the host loader; each rank packs its own copy")
    parser.add_argument("--linkInt16", default="auto", choices=["auto", "force", "off"],
                        help="host loader route: upload the audio as int16 and divide by 32767 "
                        "on the device; 'auto' when the batch is exactly int16-representable, "
                        "'force' rounds and clips")
    args = parser.parse_args(argv)

    import torch

    from ..parallel import dist as P

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    if P.launched():
        world = int(os.environ["WORLD_SIZE"])
        if args.nDevices is not None and args.nDevices != world:
            raise SystemExit(f"--nDevices {args.nDevices} under a launcher of WORLD_SIZE {world}")
    elif args.nDevices is not None and args.nDevices > 1:
        return _spawn(args, sys.argv[1:] if argv is None else list(argv))
    return _train(args)


def _spawn(args, argv):
    """Run ``argv`` in ``--nDevices`` spawned ranks on this node; returns
    rank 0's record."""
    import torch
    import torch.multiprocessing as mp

    from ..parallel.dist import free_port

    n = args.nDevices
    threads = 0
    if args.device == "cuda":
        found = torch.cuda.device_count()
        if found < n:
            raise SystemExit(f"--nDevices {n} needs {n} cards, one a rank; {found} found")
    else:  # the ranks share this process's CPU threads
        threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory() as tmp:
        record_path = os.path.join(tmp, "record.json")
        mp.spawn(_spawned_rank, args=(n, free_port(), argv, record_path, threads), nprocs=n)
        with open(record_path) as f:
            return json.load(f)


def _spawned_rank(index, world, port, argv, record_path, threads):
    """One rank of ``_spawn``: the launcher's environment, then ``main``."""
    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(index), WORLD_SIZE=str(world), LOCAL_RANK=str(index),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    try:
        record = main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if index == 0:
        with open(record_path, "w") as f:
            json.dump(record, f)


def _train(args):
    import torch

    from ..data import dataset as D
    from ..data.augment import Augmentator
    from ..data.device_dataset import INT16_SCALE, DeviceDataset
    from ..models.config import parse_conf_file
    from ..models.transkun import quantize_link
    from ..parallel import dist as P
    from ..train.checkpoint import (
        load_checkpoint, load_orbax_checkpoint, resolve_checkpoint, restore_train_state,
        restore_train_state_from_orbax, save_checkpoint,
    )
    from ..train.optim import AdaBelief
    from ..train.step import TrainState, dropout_seed, make_train_step
    from ..train.validate import do_validation
    from ..utils import compute_param_size, profiling

    group = None
    device = torch.device(args.device)
    if P.init_distributed(args.device):
        group = torch.distributed.group.WORLD
        device = P.rank_device(args.device)
    rank, world = P.process_info()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    module_mod, conf = parse_conf_file(args.modelConf)
    if args.gradientCheckpoint != "auto":
        conf.useGradientCheckpoint = args.gradientCheckpoint == "on"
    run_seed = int(time.time()) if args.seed is None else args.seed
    # every rank builds the same weights from rank 0's seed, and takes rank
    # 0's weights besides (ref: rank 0 initializes, train.py:53-73)
    run_seed = int(P.broadcast_from_0(torch.tensor(run_seed, dtype=torch.int64), group))
    model = module_mod.TransKun(conf, device=device, seed=run_seed % 2**31,
                                compute_dtype=torch.bfloat16 if args.bf16 else None)
    if group is not None:
        P.broadcast_module_(model.module, group)
    if rank == 0:
        print(f"device: {device}, batch: {args.batchSize} a rank, {world} rank(s), global batch: "
              f"{args.batchSize * world}, bf16: {args.bf16}")
        print(f"#Param(M): {compute_param_size(model.module):.2f}")

    optimizer = AdaBelief(
        model.module.named_parameters(), max_lr=args.max_lr, weight_decay=args.weight_decay,
        n_iter=args.nIter, warmup_cutoff=args.warmupCutoff,
    )
    state = TrainState(model, optimizer)
    step_fn = make_train_step(model, clip_quantile=args.gradClippingQuantile, group=group)

    def snapshot():
        return {k: v.detach().clone() for k, v in model.module.state_dict().items()}

    best_state_dict = snapshot()
    loss_tracker = {"train": [], "val": []}
    start_epoch = 0
    carried = {}  # extra keys the run keeps as it found them (warmstart_from)
    # a JAX run's checkpoint directory is read, never written: the port saves beside it
    plan = resolve_checkpoint(args.saved_filename)
    ckpt_path = plan.save_path
    if plan.source is not None:  # every rank loads the same checkpoint
        if rank == 0:
            print("resuming from checkpoint...")
            what = "the JAX package's orbax checkpoint" if plan.kind == "jax" else "checkpoint"
            print(f"resuming from {what} {plan.source}; saving to {plan.save_path}", flush=True)
        if plan.kind == "jax":
            ckpt = restore_train_state_from_orbax(state, load_orbax_checkpoint(plan.source), conf)
        else:
            ckpt = load_checkpoint(plan.source)
            restore_train_state(state, ckpt)
        best_state_dict = ckpt.get("best_state_dict", ckpt["state_dict"])
        extra = dict(ckpt.get("extra", {}) or {})
        loss_tracker = extra.pop("loss_tracker", loss_tracker)
        start_epoch = int(extra.pop("epoch", 0))
        # continue the data stream of the interrupted run (and, after a port
        # run, its dropout stream; a JAX run's dropout is jax.random's)
        run_seed = int(extra.pop("run_seed", run_seed))
        carried = extra

    def save(epoch, message=None):
        if rank == 0:
            with profiling.root("transkun.ckpt", state.step):
                save_checkpoint(ckpt_path, state, best_state_dict,
                                {**carried, "loss_tracker": loss_tracker, "epoch": epoch, "run_seed": run_seed})
            if message:
                print(message, flush=True)
        P.barrier(group)

    def log(*a, **kw):
        if rank == 0:
            print(*a, **kw)

    writer = None
    if rank == 0:  # the JAX package's rule: no tensorboardX, no log
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            print("tensorboardX is not installed: no TensorBoard log")
        else:
            writer = SummaryWriter(args.saved_filename + ".log")  # a resumed JAX run's log goes on

    def scalars(values, step):
        if writer is not None:
            for tag, value in values.items():
                writer.add_scalar(tag, value, step)

    k_sync = None
    if group is not None:
        # label K auto-grow agrees across ranks, so every rank pads alike
        def k_sync(densest: int) -> int:
            return int(P.all_reduce_max(torch.tensor(densest, dtype=torch.int64), group))

    dataset = D.DatasetMaestro(args.datasetPath, args.datasetMetaFile_train)
    dataset_val = D.DatasetMaestro(args.datasetPath, args.datasetMetaFile_val)

    hop = args.hopSize or conf.segmentHopSizeInSecond
    chunk = args.chunkSize or conf.segmentSizeInSecond
    n_chunk_samples = int(chunk * conf.fs)
    augmentator = None
    if args.augment:
        augmentator = Augmentator(
            sampleRate=conf.fs, noiseFolder=args.noiseFolder, convIRFolder=args.irFolder
        )

    device_data = None
    if args.deviceData != "off":
        if augmentator is not None:
            if args.deviceData == "on":
                raise SystemExit("--deviceData on is incompatible with: host augmentation")
        else:
            try:
                device_data = DeviceDataset(dataset, n_chunk_samples, device=device)
                log(f"device-resident corpus: {device_data.nbytes / 2**30:.2f} GiB int16 on {device}",
                    flush=True)
            except ValueError as e:
                if args.deviceData == "on":
                    raise
                print(f"device dataset unavailable ({e}); using host loader")
            except torch.cuda.OutOfMemoryError as e:
                # the size guard cannot see the memory the model and optimizer
                # already hold
                if args.deviceData == "on":
                    raise
                print(f"device corpus does not fit the device's memory ({type(e).__name__}); "
                      "using host loader")
    link_mode = {"auto": None, "force": True, "off": False}[args.linkInt16]
    link_dtypes = set()

    record = {"losses": [], "step_seconds": [], "iter_seconds": [], "step_peak_bytes": 0,
              "stats_seconds": [], "steps": 0, "stats_passes": 0, "val_batches": 0,
              "val_results": [], "device_data": device_data is not None,
              "device_data_bytes": 0 if device_data is None else device_data.nbytes,
              "link_dtype": None}
    global_step = state.step
    phases_shown = profiling.totals()  # the span totals at the last [train] line
    try:
        for epoch in range(start_epoch, args.maxEpoch):
            data_iter = D.DatasetMaestroIterator(
                dataset, hop, chunk, seed=epoch * 100 + run_seed, augmentator=augmentator,
                notes_strictly_contained=False, skip_audio=device_data is not None,
            )
            # each rank loads its shard of the epoch's chunks; every rank takes
            # the smallest shard's count of steps, so the collectives pair up
            loader = D.BatchLoader(
                data_iter, args.batchSize, shuffle=True, seed=epoch, drop_last=True,
                rank=rank, world_size=world, num_workers=args.dataLoaderWorkers,
                collate=D.collate_fn_device if device_data is not None else D.collate_fn_batching,
            )
            n_steps = len(data_iter) // world // args.batchSize
            loss_all = []
            pending_log = []

            t_iter = time.perf_counter()  # an iteration's wall includes the loader's wait
            batches = iter(loader)
            for idx in range(n_steps):
                with profiling.root("transkun.input", global_step):
                    batch = next(batches, None)
                    if batch is None:
                        break
                    notes_batch = batch["notes"]
                    with profiling.span("transkun.slice"):
                        if device_data is not None:
                            # only the chunks' starts cross to the device
                            audio = device_data.slice_batch(
                                device_data.starts_for(batch["pieceIdx"], batch["begins"]))
                            linked = audio
                        else:
                            # chunk bounds are float seconds, so lengths jitter
                            # by a sample: crop to one size.  Only the frames'
                            # copy takes the link; the stats pass decodes the
                            # float batch
                            audio = batch["audioSlices"][:, :n_chunk_samples]
                            linked = quantize_link(audio, link_mode, INT16_SCALE)
                            link_dtypes.add(str(linked.dtype))
                    with profiling.span("transkun.frames"):
                        frames = model.frames(linked)
                    with profiling.span("transkun.labels"):
                        labels = model.labels(notes_batch, args.maxEvents, k_sync=k_sync)
                    generator = torch.Generator(device=device).manual_seed(
                        dropout_seed(run_seed, global_step, rank))
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                t_step = time.perf_counter()
                metrics = step_fn(state, frames, labels, generator)
                if device.type == "cuda":
                    record["step_peak_bytes"] = max(
                        record["step_peak_bytes"], torch.cuda.max_memory_allocated(device)
                    )
                record["steps"] += 1
                pending_log.append((epoch, idx, global_step, metrics, t_step, t_iter))
                if len(pending_log) >= max(args.logEvery, 1) or idx == n_steps - 1:
                    with profiling.root("transkun.fetch", global_step):
                        fetched = torch.stack([
                            torch.stack([m["loss"], m["grad_norm"], m["clip_value"], m["finite"].float()])
                            for *_, m, _, _ in pending_log
                        ]).cpu().numpy()
                        profiling.count("fetches")
                    # wall seconds per step since the first pending step (or its
                    # iteration) began; with --logEvery 1 it is the step alone
                    now = time.perf_counter()
                    dt = (now - pending_log[0][4]) / len(pending_log)
                    dt_iter = (now - pending_log[0][5]) / len(pending_log)
                    bad_step = None
                    for (ep_i, idx_i, gs_i, *_), (loss, gnorm, clipv, fin) in zip(pending_log, fetched):
                        log(
                            f"epoch:{ep_i} progress:{idx_i / max(n_steps, 1):0.3f} "
                            f"step:{gs_i} loss:{loss:0.4f} gradNorm:{gnorm:0.2f} "
                            f"clipValue:{clipv:0.2f} time:{dt:0.2f}",
                            flush=True,
                        )
                        scalars({"Loss/train": loss, "Optimizer/gradNorm": gnorm,
                                 "Optimizer/clipValue": clipv}, gs_i)
                        loss_all.append(float(loss))
                        record["losses"].append(float(loss))
                        record["step_seconds"].append(dt)
                        record["iter_seconds"].append(dt_iter)
                        if not fin and bad_step is None:
                            bad_step = gs_i
                    pending_log.clear()
                    if rank == 0 and os.environ.get(profiling.ENV) not in (None, "", "silent"):
                        phases = profiling.totals()
                        print(_phase_line(phases_shown, phases), flush=True)
                        phases_shown = phases
                    if bad_step is not None:
                        # the step skipped the update on the device (on every
                        # rank: the flag is of the summed values), so the state
                        # a checkpoint would hold is the last good one
                        log(f"non-finite loss/grad at step {bad_step} (update skipped), aborting")
                        raise SystemExit(1)

                if args.statsEvery > 0 and idx % args.statsEvery == 0 and rank == 0:
                    t_stats = time.perf_counter()  # both passes end in host numbers
                    with profiling.root("transkun.stats", global_step):
                        stats = model.compute_stats(audio, notes_batch)
                        stats2 = model.compute_stats_mireval(audio, notes_batch)
                        profiling.count("stats_passes")
                    record["stats_seconds"].append(time.perf_counter() - t_stats)
                    record["stats_passes"] += 1
                    n_gt = stats2["nGT"] + 1e-4
                    n_est = stats2["nEst"] + 1e-4
                    n_cor = stats2["nCorrect"] + 1e-4
                    p, r = n_cor / n_est, n_cor / n_gt
                    f1 = 2 * p * r / (p + r)
                    fw_p = (stats["nCorrectFramewise"] + 1e-4) / (stats["nEstFramewise"] + 1e-4)
                    fw_r = (stats["nCorrectFramewise"] + 1e-4) / (stats["nGTFramewise"] + 1e-4)
                    fw_f1 = 2 * fw_p * fw_r / (fw_p + fw_r)
                    print(f"f1:{f1:.4f} precision:{p:.4f} recall:{r:.4f} f1Frame:{fw_f1:.4f}")
                    scalars({"Loss/train_f1": f1, "Loss/train_precision": p, "Loss/train_recall": r,
                             "Loss/train_f1_frame": fw_f1,
                             "Loss/train_mse_velocity": stats["seVelocityForced"] / n_gt,
                             "Loss/train_mse_OF": stats["seOFForced"] / n_gt}, global_step)

                if idx % args.ckptEvery == args.ckptEvery - 1:
                    save(epoch, "saved")
                global_step += 1
                if args.stopAtStep is not None and global_step >= args.stopAtStep:
                    break
                t_iter = time.perf_counter()

            if args.stopAtStep is not None and global_step >= args.stopAtStep:
                save(epoch, f"stopAtStep {args.stopAtStep} reached; saved")
                break

            loss_tracker["train"].append(sum(loss_all) / max(len(loss_all), 1))
            if (epoch + 1) % max(args.validateEvery, 1) != 0:
                save(epoch + 1)
                continue

            # each rank validates its shard; the counts are summed over the ranks
            log("Validating...", flush=True)
            val_iter = D.DatasetMaestroIterator(
                dataset_val, conf.segmentHopSizeInSecond, chunk,
                notes_strictly_contained=False, seed=run_seed + epoch * 100,
            )
            val_loader = D.BatchLoader(
                val_iter, min(2 * args.batchSize * world, max(len(val_iter), 1)),
                shuffle=True, seed=epoch, drop_last=False, rank=rank, world_size=world,
            )
            val_result = do_validation(model, val_loader, conf.fs, group)
            record["val_batches"] += len(val_loader)
            record["val_results"].append(val_result)
            log("result:", val_result, flush=True)
            scalars({"val/" + k: v for k, v in val_result.items()}, epoch)
            loss_tracker["val"].append(val_result["f1"])
            if val_result["f1"] >= max(loss_tracker["val"]):
                log("best updated", flush=True)
                best_state_dict = snapshot()
            save(epoch + 1)
    finally:
        if writer is not None:
            writer.close()
    record["link_dtype"] = "+".join(sorted(link_dtypes)) or None
    return record


def _phase_line(before, after) -> str:
    """``[train]`` and each phase's mean host milliseconds a step between
    two readings of the span totals (name -> (count, seconds)), the step's
    own phases in brackets; a phase that did not run is left out."""
    steps = max(after.get("transkun.step", (0, 0.0))[0] - before.get("transkun.step", (0, 0.0))[0], 1)

    def phases(*names):
        words = []
        for name in names:
            c0, s0 = before.get("transkun." + name, (0, 0.0))
            c1, s1 = after.get("transkun." + name, (0, 0.0))
            if c1 > c0:
                words.append(f"{name} {(s1 - s0) * 1e3 / steps:.1f}")
        return " ".join(words)

    return (f"[train] {phases('input', 'step')} ({phases('forward', 'backward', 'allreduce', 'clip', 'optimizer')}) "
            f"{phases('fetch', 'stats')} ms a step")


def cli():
    """The console script: ``main`` without its record (a returned object
    would become the exit status), leaving a launcher's group."""
    main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    cli()
