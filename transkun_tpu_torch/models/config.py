"""Model configuration for the port: the ``ModelConfig`` dataclass of
``transkun_tpu.models.config`` (same fields, same defaults) and the JSON conf
loader.

The JAX package's config module cannot be imported without JAX (its package
``__init__`` pulls in the flax model), so the port carries this copy.  Conf
files name a model module; every name the JAX package accepts for the V2
model maps to ``transkun_tpu_torch.models.transkun``, and for the V1 model
to ``transkun_tpu_torch.models.ablation``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict, Tuple


@dataclasses.dataclass
class ModelConfig:
    f_min: float = 30
    f_max: float = 8000
    n_mels: int = 229

    segmentHopSizeInSecond: float = 8
    segmentSizeInSecond: float = 16

    hopSize: int = 1024
    windowSize: int = 4096
    fs: int = 44100
    nExtraWins: int = 5

    baseSize: int = 40
    downsampleF: bool = True

    posEmbedInitGamma: float = 1

    nHead: int = 4
    fourierSize: int = 64

    nLayers: int = 6
    enabledAttn: Tuple[str, ...] = ("F", "T")
    hiddenFactorAttn: float = 1
    hiddenFactor: float = 4

    velocityPredictorHiddenSize: int = 512
    refinedOFPredictorHiddenSize: int = 512

    scoringExpansionFactor: int = 4
    useInnerProductScorer: bool = True

    upsampleProjOnly: bool = True

    scoreDropoutProb: float = 0.1
    contextDropoutProb: float = 0.1
    velocityDropoutProb: float = 0.1
    refinedOFDropoutProb: float = 0.1

    useGradientCheckpoint: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if "enabledAttn" in kwargs:
            kwargs["enabledAttn"] = tuple(kwargs["enabledAttn"])
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["enabledAttn"] = list(d["enabledAttn"])
        return d


Config = ModelConfig

_PORT_MODEL = "transkun_tpu_torch.models.transkun"
_PORT_MODEL_V1 = "transkun_tpu_torch.models.ablation"

# module names in conf files (reference and JAX package) -> the port's module
_MODULE_ALIASES = {
    "transkun.ModelTransformer": _PORT_MODEL,
    "transkun_tpu.models.transkun": _PORT_MODEL,
    "transkun.Model_ablation": _PORT_MODEL_V1,
    "transkun_tpu.models.ablation": _PORT_MODEL_V1,
}


def parse_conf_file(path: str):
    """Parse a reference-style JSON conf.  Returns (model_module, config):
    the V2 module exposes ``TransKun``, the V1 module ``TransKunAblation``."""
    with open(path) as f:
        conf = json.load(f)
    entry = conf["Model"]
    module_name = _MODULE_ALIASES.get(entry["module"], entry["module"])
    if module_name not in (_PORT_MODEL, _PORT_MODEL_V1):
        raise NotImplementedError(
            f"model module {entry['module']!r} is not ported "
            f"(only the V2 model, {_PORT_MODEL}, and the V1 model, {_PORT_MODEL_V1})"
        )
    module = importlib.import_module(module_name)
    config_cls = getattr(module, entry.get("configClassName", "Config"))
    return module, config_cls.from_dict(entry.get("config", {}))


def default_conf_path() -> str:
    """Path of the shipped flagship V2 conf, the port's own copy."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "pretrained", "2.0.conf"))


def load_default_conf():
    """(model_module, config) for the shipped flagship V2 configuration."""
    return parse_conf_file(default_conf_path())
