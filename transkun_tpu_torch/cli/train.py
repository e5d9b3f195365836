"""Training CLI of the port (counterpart of ``transkun_tpu/cli/train.py`` and
the reference ``python3 -m transkun.train``), one process on one device:

    python -m transkun_tpu_torch.cli.train ckpt.pt \
        --datasetPath ... --datasetMetaFile_train train.pickle \
        --datasetMetaFile_val val.pickle --modelConf conf.json [--device cpu]

Host loader -> label encoding -> semi-CRF NLL + attribute NLLs -> backward ->
quantile clip -> rectified AdaBelief, with a stats decode every
``--statsEvery`` steps, validation every ``--validateEvery`` epochs and a
crash-safe checkpoint file.  The data modules are the port's own
``data`` package.  fp32 unless ``--bf16`` (bfloat16 activations; parameters,
loss, gradients, clip and optimizer stay fp32, and so do the checkpoints);
TF32 is turned off for matmuls and convolutions.  The default device is
``cuda`` and the command fails when CUDA is absent; ``--device cpu`` runs
the plain PyTorch versions of the kernels.

``main`` returns a record of the run (losses, per-step seconds, the largest
per-step device memory, the seconds of each stats pass, and the counts of
steps, stats passes and validation batches) for callers that drive it from
Python.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser("Perform Training (PyTorch port)")
    parser.add_argument("saved_filename", help="checkpoint file")
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
    # options of the JAX trainer that this port does not have yet: they
    # raise instead of being ignored
    parser.add_argument("--nDevices", default=None, type=int)
    parser.add_argument("--deviceData", default="auto", choices=["auto", "on", "off"])
    parser.add_argument("--linkInt16", default="auto", choices=["auto", "force", "off"])
    args = parser.parse_args(argv)

    not_ported = [
        (args.nDevices is not None and args.nDevices > 1, "--nDevices > 1 (multi-process training)"),
        (args.deviceData == "on", "--deviceData on (device-resident corpus)"),
        (args.linkInt16 == "force", "--linkInt16 force"),
    ]
    missing = [name for bad, name in not_ported if bad]
    if missing:
        raise SystemExit(f"not ported yet: {', '.join(missing)}")

    import torch

    from ..data import dataset as D
    from ..data.augment import Augmentator
    from ..models.config import parse_conf_file
    from ..train.checkpoint import checkpoint_exists, load_checkpoint, restore_train_state, save_checkpoint
    from ..train.optim import AdaBelief
    from ..train.step import TrainState, make_train_step
    from ..train.validate import do_validation
    from ..utils import compute_param_size

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    module_mod, conf = parse_conf_file(args.modelConf)
    if args.gradientCheckpoint != "auto":
        conf.useGradientCheckpoint = args.gradientCheckpoint == "on"
    run_seed = int(time.time()) if args.seed is None else args.seed
    model = module_mod.TransKun(conf, device=device, seed=run_seed % 2**31,
                                compute_dtype=torch.bfloat16 if args.bf16 else None)
    print(f"device: {device}, batch: {args.batchSize}, bf16: {args.bf16}")
    print(f"#Param(M): {compute_param_size(model.module):.2f}")

    optimizer = AdaBelief(
        model.module.named_parameters(), max_lr=args.max_lr, weight_decay=args.weight_decay,
        n_iter=args.nIter, warmup_cutoff=args.warmupCutoff,
    )
    state = TrainState(model, optimizer)
    step_fn = make_train_step(model, clip_quantile=args.gradClippingQuantile)

    def snapshot():
        return {k: v.detach().clone() for k, v in model.module.state_dict().items()}

    best_state_dict = snapshot()
    loss_tracker = {"train": [], "val": []}
    start_epoch = 0
    ckpt_path = args.saved_filename
    if checkpoint_exists(ckpt_path):
        print("resuming from checkpoint...")
        ckpt = load_checkpoint(ckpt_path)
        restore_train_state(state, ckpt)
        best_state_dict = ckpt.get("best_state_dict", ckpt["state_dict"])
        extra = ckpt.get("extra", {}) or {}
        loss_tracker = extra.get("loss_tracker", loss_tracker)
        start_epoch = int(extra.get("epoch", 0))
        # continue the exact data and dropout stream of the interrupted run
        run_seed = int(extra.get("run_seed", run_seed))

    def save(epoch):
        save_checkpoint(ckpt_path, state, best_state_dict,
                        {"loss_tracker": loss_tracker, "epoch": epoch, "run_seed": run_seed})

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

    record = {"losses": [], "step_seconds": [], "step_peak_bytes": 0, "stats_seconds": [],
              "steps": 0, "stats_passes": 0, "val_batches": 0, "val_results": []}
    global_step = state.step
    for epoch in range(start_epoch, args.maxEpoch):
        data_iter = D.DatasetMaestroIterator(
            dataset, hop, chunk, seed=epoch * 100 + run_seed, augmentator=augmentator,
            notes_strictly_contained=False,
        )
        loader = D.BatchLoader(
            data_iter, args.batchSize, shuffle=True, seed=epoch, drop_last=True,
            num_workers=args.dataLoaderWorkers,
        )
        loss_all = []
        pending_log = []

        for idx, batch in enumerate(loader):
            notes_batch = batch["notes"]
            # chunk bounds are float seconds, so lengths jitter by a sample:
            # crop to one size
            audio = batch["audioSlices"][:, :n_chunk_samples]
            frames = model.frames(audio)
            labels = model.labels(notes_batch, args.maxEvents)
            generator = torch.Generator(device=device).manual_seed(global_step * 7919 + run_seed)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t_step = time.perf_counter()
            metrics = step_fn(state, frames, labels, generator)
            if device.type == "cuda":
                record["step_peak_bytes"] = max(
                    record["step_peak_bytes"], torch.cuda.max_memory_allocated(device)
                )
            record["steps"] += 1
            pending_log.append((epoch, idx, global_step, metrics, t_step))
            if len(pending_log) >= max(args.logEvery, 1) or idx == len(loader) - 1:
                fetched = torch.stack([
                    torch.stack([m["loss"], m["grad_norm"], m["clip_value"], m["finite"].float()])
                    for *_, m, _ in pending_log
                ]).cpu().numpy()
                # wall seconds per step since the first pending step began;
                # with --logEvery 1 it is the step alone
                dt = (time.perf_counter() - pending_log[0][4]) / len(pending_log)
                bad_step = None
                for (ep_i, idx_i, gs_i, _, _), (loss, gnorm, clipv, fin) in zip(pending_log, fetched):
                    print(
                        f"epoch:{ep_i} progress:{idx_i / max(len(loader), 1):0.3f} "
                        f"step:{gs_i} loss:{loss:0.4f} gradNorm:{gnorm:0.2f} "
                        f"clipValue:{clipv:0.2f} time:{dt:0.2f}",
                        flush=True,
                    )
                    loss_all.append(float(loss))
                    record["losses"].append(float(loss))
                    record["step_seconds"].append(dt)
                    if not fin and bad_step is None:
                        bad_step = gs_i
                pending_log.clear()
                if bad_step is not None:
                    # the step skipped the update on the device, so the state
                    # a checkpoint would hold is the last good one
                    print(f"non-finite loss/grad at step {bad_step} (update skipped), aborting")
                    raise SystemExit(1)

            if args.statsEvery > 0 and idx % args.statsEvery == 0:
                t_stats = time.perf_counter()  # both passes end in host numbers
                stats = model.compute_stats(audio, notes_batch)
                stats2 = model.compute_stats_mireval(audio, notes_batch)
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

            if idx % args.ckptEvery == args.ckptEvery - 1:
                save(epoch)
                print("saved", flush=True)
            global_step += 1
            if args.stopAtStep is not None and global_step >= args.stopAtStep:
                break

        if args.stopAtStep is not None and global_step >= args.stopAtStep:
            save(epoch)
            print(f"stopAtStep {args.stopAtStep} reached; saved", flush=True)
            break

        loss_tracker["train"].append(sum(loss_all) / max(len(loss_all), 1))
        if (epoch + 1) % max(args.validateEvery, 1) != 0:
            save(epoch + 1)
            continue

        print("Validating...", flush=True)
        val_iter = D.DatasetMaestroIterator(
            dataset_val, conf.segmentHopSizeInSecond, chunk,
            notes_strictly_contained=False, seed=run_seed + epoch * 100,
        )
        val_loader = D.BatchLoader(
            val_iter, min(2 * args.batchSize, max(len(val_iter), 1)),
            shuffle=True, seed=epoch, drop_last=False,
        )
        val_result = do_validation(model, val_loader, conf.fs)
        record["val_batches"] += len(val_loader)
        record["val_results"].append(val_result)
        print("result:", val_result, flush=True)
        loss_tracker["val"].append(val_result["f1"])
        if val_result["f1"] >= max(loss_tracker["val"]):
            print("best updated", flush=True)
            best_state_dict = snapshot()
        save(epoch + 1)
    return record


if __name__ == "__main__":
    main()
