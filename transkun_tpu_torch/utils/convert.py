"""The JAX package's flax params -> the port's state_dict.

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
  free bias per output step (a reference [out] bias is tiled 8x on load)
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
    if "upConv1d" in bb:
        raise NotImplementedError("upsampleProjOnly=False (upConv1d) is not ported")
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

    up = bb["upConv1dSkip"]
    kernel = np.asarray(up["kernel"])  # [in, 8*out], step-major columns
    sd["backbone.upConv1dSkip.weight"] = _t(
        kernel.reshape(kernel.shape[0], 8, -1).transpose(0, 2, 1)
    )
    sd["backbone.upConv1dSkip.bias"] = _t(up["bias"])

    linear("scorer.map.0", p["scorer"]["map"])
    mlp("velocityPredictor", p["velocityPredictor"])
    mlp("refinedOFPredictor", p["refinedOFPredictor"])
    return sd


def load_reference_checkpoint(path: str, prefer_best: bool = True):
    """state_dict from a reference ``.pt`` checkpoint (``best_state_dict``
    preferred) or from a file that holds a plain state_dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if prefer_best and "best_state_dict" in ckpt:
        return ckpt["best_state_dict"]
    return ckpt.get("state_dict", ckpt)
