"""The JAX package's flax params -> the port's state_dict (the V2 model:
``state_dict_from_flax``; the V1 model: ``state_dict_from_flax_ablation``).

Exact inverse of ``transkun_tpu.utils.torch_convert.convert_state_dict``:
the port's module names are the reference PyTorch model's, so a reference
``.pt`` loads into the port with ``load_state_dict(strict=True)`` as it is,
and flax params (a nested dict of numpy arrays) come across through this
function.  Layouts:

* flax Dense kernel [in, out]          -> Linear weight [out, in]
* MHA q/k/v kernels [in, out]          -> ``*_proj_weight`` [in, out]
* flax Conv kernel [kh, kw, in, out]   -> Conv2d weight [out, in, kh, kw]
* upConv1dSkip Dense [in, 8*out]       -> weight [in, out, 8] (the
  reference ConvTranspose1d layout); its bias [8*out] stays as it is, one
  free bias per output step (a reference [out] bias is tiled 8x on load);
  the same for ``upConv1d``'s three Dense [in, 2*out] stages, whose convs
  (flax Conv1d kernel [k, in, out] -> Conv1d weight [out, in, k]) and
  norms sit at the reference's indices
* the pairwise scorer (``useInnerProductScorer`` false): ``scorerProj``
  and the V1 ``PairwiseFeatureBatch``'s keys under ``scorer.``
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_flax(params: Dict[str, Any], conf=None) -> "OrderedDict[str, torch.Tensor]":
    """flax params (``{"params": ...}`` or the inner dict) -> state_dict."""
    p = params.get("params", params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def linear(prefix, d):
        sd[prefix + ".weight"] = _t(np.asarray(d["kernel"]).T)
        sd[prefix + ".bias"] = _t(d["bias"])

    def conv2d(prefix, d):
        sd[prefix + ".weight"] = _t(np.transpose(np.asarray(d["kernel"]), (3, 2, 0, 1)))
        sd[prefix + ".bias"] = _t(d["bias"])

    def groupnorm(prefix, d):
        sd[prefix + ".weight"] = _t(d["scale"])
        sd[prefix + ".bias"] = _t(d["bias"])

    def mlp(prefix, d):
        linear(prefix + ".0", d["lin1"])
        linear(prefix + ".3", d["lin2"])

    def pos_embed(prefix, d):
        linear(prefix + ".proj", d["proj"])
        linear(prefix + ".mlp.0", d["mlp_0"])
        linear(prefix + ".mlp.3", d["mlp_1"])

    def upsample(prefix, d, steps):  # Dense [in, steps*out], step-major columns
        kernel = np.asarray(d["kernel"])
        sd[prefix + ".weight"] = _t(kernel.reshape(kernel.shape[0], steps, -1).transpose(0, 2, 1))
        sd[prefix + ".bias"] = _t(d["bias"])

    win = "framewiseFeatureExtractor.spectrogramExtractor.winGen"
    sd[win + ".sigma"] = _t(p["frontend"]["win_sigma"])
    sd[win + ".center"] = _t(p["frontend"]["win_center"])

    bb = p["backbone"]
    for name in ("posEmbedBuilder", "posEmbedBuilderAttnTF", "posEmbedBuilderAttnTE"):
        pos_embed("backbone." + name, bb[name])
    conv2d("backbone.inputConv", bb["inputConv"])
    for i, idx in enumerate((1, 5, 9, 13)):
        conv2d(f"backbone.downConv.{idx}", bb["downConv"][f"conv{i}"])
        groupnorm(f"backbone.downConv.{idx + 1}", bb["downConv"][f"norm{i}"])
    i = 0
    while f"encoderLayers_{i}" in bb:
        layer = bb[f"encoderLayers_{i}"]
        base = f"backbone.encoderLayers.{i}"
        for key, blk in layer.items():
            if key.startswith("mhaBlock"):
                sd[f"{base}.{key}.scale"] = _t(blk["scale"])
                for proj in ("q_proj", "k_proj", "v_proj"):
                    sd[f"{base}.{key}.module.{proj}_weight"] = _t(blk["mha"][proj]["kernel"])
                linear(f"{base}.{key}.module.out_proj", blk["mha"]["out_proj"])
            else:
                sd[f"{base}.{key}.scale"] = _t(blk["scale"])
                mlp(f"{base}.{key}.module", blk)
        i += 1

    upsample("backbone.upConv1dSkip", bb["upConv1dSkip"], 8)
    if "upConv1d" in bb:
        stack = bb["upConv1d"]
        for i, idx in enumerate((0, 4, 8)):
            upsample(f"backbone.upConv1d.{idx}", stack[f"up{i}"], 2)
            conv = stack[f"conv{i}"]
            sd[f"backbone.upConv1d.{idx + 1}.weight"] = _t(
                np.transpose(np.asarray(conv["kernel"]), (2, 1, 0)))
            sd[f"backbone.upConv1d.{idx + 1}.bias"] = _t(conv["bias"])
            if f"norm{i}" in stack:
                groupnorm(f"backbone.upConv1d.{idx + 2}", stack[f"norm{i}"])

    if "scorerProj" in p:
        linear("scorerProj", p["scorerProj"])
        _pairwise_scorer(sd, "scorer", p["scorer"])
    else:
        linear("scorer.map.0", p["scorer"]["map"])
    mlp("velocityPredictor", p["velocityPredictor"])
    mlp("refinedOFPredictor", p["refinedOFPredictor"])
    return sd


def state_dict_from_flax_ablation(variables: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """flax V1 variables ``{"params": ..., "batch_stats": ...}`` -> the
    state_dict of ``models.ablation.TransKunAblationModule``: the inverse of
    ``transkun_tpu.utils.torch_convert.convert_state_dict_ablation``, with
    the reference V1 model's key names.

    flax's GRUCell has one bias for each of the r and z gates where
    ``nn.GRU`` has two that add: the merged value goes into ``bias_ih`` and
    ``bias_hh`` is zero for r and z.  The n gate's biases stay apart,
    because r multiplies ``bias_hh``'s n part.  BatchNorm's
    ``num_batches_tracked``, which flax does not keep, is 0."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def linear(prefix, d):
        sd[prefix + ".weight"] = _t(np.asarray(d["kernel"]).T)
        sd[prefix + ".bias"] = _t(d["bias"])

    def conv2d(prefix, d):
        sd[prefix + ".weight"] = _t(np.transpose(np.asarray(d["kernel"]), (3, 2, 0, 1)))
        sd[prefix + ".bias"] = _t(d["bias"])

    def mlp3(prefix, d, names):
        for idx, name in zip((0, 3, 6), names):
            linear(f"{prefix}.{idx}", d[name])

    win = "framewiseFeatureExtractor.spectrogramExtractor.winGen"
    sd[win + ".sigma"] = _t(p["frontend"]["win_sigma"])
    sd[win + ".center"] = _t(p["frontend"]["win_center"])
    i = 0
    while f"preLayer_{i}" in p:
        block, base = p[f"preLayer_{i}"], f"preLayer.layers.{i}"
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            conv2d(f"{base}.{conv}", block[conv])
            sd[f"{base}.{bn}.weight"] = _t(block[bn]["scale"])
            sd[f"{base}.{bn}.bias"] = _t(block[bn]["bias"])
            sd[f"{base}.{bn}.running_mean"] = _t(stats[f"preLayer_{i}"][bn]["mean"])
            sd[f"{base}.{bn}.running_var"] = _t(stats[f"preLayer_{i}"][bn]["var"])
            sd[f"{base}.{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        i += 1
    linear("inputProj.0", p["inputProj"])

    ctx = p["contextModel"]
    layer = 0
    while f"gru{layer}_fwd" in ctx:
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            cell = ctx[f"gru{layer}_{direction}"]
            key = f"contextModel.grus.{{}}_l{layer}{suffix}"
            sd[key.format("weight_ih")] = _t(np.concatenate(
                [np.asarray(cell[g]["kernel"]).T for g in ("ir", "iz", "in")]))
            sd[key.format("weight_hh")] = _t(np.concatenate(
                [np.asarray(cell[g]["kernel"]).T for g in ("hr", "hz", "hn")]))
            sd[key.format("bias_ih")] = _t(np.concatenate(
                [np.asarray(cell[g]["bias"]) for g in ("ir", "iz", "in")]))
            hn = np.asarray(cell["hn"]["bias"])
            sd[key.format("bias_hh")] = _t(np.concatenate([np.zeros(2 * hn.shape[0]), hn]))
        layer += 1
    linear("contextModel.outProj", ctx["outProj"])

    _pairwise_scorer(sd, "pairwiseScore", p["pairwiseScore"])
    sd["pitchEmbedding.weight"] = _t(p["pitchEmbedding"]["embedding"])
    for head in ("velocityPredictor", "refinedOFPredictor"):
        mlp3(head, p[head], ("lin1", "lin2", "lin3"))
    return sd


def _pairwise_scorer(sd, prefix: str, pw: Dict[str, Any]) -> None:
    """The flax ``PairwiseFeatureBatch`` params ``pw`` into ``sd`` under
    ``prefix`` with the reference's names: the two 3-layer MLPs at indices
    0, 3, 6 and the post-convolutions at 0 and 3."""
    for name in ("scoreMap", "scoreMapSkip"):
        for idx, j in zip((0, 3, 6), range(3)):
            d = pw[f"{name}_{j}"]
            sd[f"{prefix}.{name}.{idx}.weight"] = _t(np.asarray(d["kernel"]).T)
            sd[f"{prefix}.{name}.{idx}.bias"] = _t(d["bias"])
    if "post" in pw:
        for idx, conv in ((0, "conv1"), (3, "conv2")):
            d = pw["post"][conv]
            sd[f"{prefix}.post.map.{idx}.weight"] = _t(
                np.transpose(np.asarray(d["kernel"]), (3, 2, 0, 1)))
            sd[f"{prefix}.post.map.{idx}.bias"] = _t(d["bias"])


def load_reference_checkpoint(path: str, prefer_best: bool = True):
    """state_dict from a reference ``.pt`` checkpoint (``best_state_dict``
    preferred) or from a file that holds a plain state_dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if prefer_best and "best_state_dict" in ckpt:
        return ckpt["best_state_dict"]
    return ckpt.get("state_dict", ckpt)
