"""Weights and config carried across: flax params -> the port's state_dict
(reference-torch key names) and back through the JAX package's own
converter, leaf for leaf; the config dataclass; and the port's imports
staying free of JAX."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np

from transkun_tpu.models import TransKun as JaxTransKun
from transkun_tpu.models.config import ModelConfig as JaxModelConfig
from transkun_tpu.models.config import load_default_conf as jax_load_default_conf
from transkun_tpu.utils.torch_convert import convert_state_dict
from transkun_tpu_torch.models.config import ModelConfig, load_default_conf
from transkun_tpu_torch.models.transkun import TransKun
from transkun_tpu_torch.utils.convert import state_dict_from_flax

TINY = {
    "f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256,
    "fs": 4000, "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 2,
    "scoringExpansionFactor": 2, "segmentSizeInSecond": 2.0,
    "segmentHopSizeInSecond": 1.0,
}


def test_flax_params_round_trip_through_state_dict():
    conf = JaxModelConfig.from_dict(TINY)
    jax_model = JaxTransKun(conf)
    params = jax.jit(lambda k: jax_model.init(k, n_frames=126))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = TransKun(ModelConfig.from_dict(TINY), device="cpu")
    model.load_state_dict(state_dict_from_flax(params, conf))  # strict
    # the JAX converter reads the reference's tied [out] upsample bias; at
    # init the port's untied [8*out] bias is zero, so its first step is it
    sd = dict(model.module.state_dict())
    bias = sd["backbone.upConv1dSkip.bias"]
    out = bias.numel() // 8
    assert np.array_equal(bias.numpy(), np.tile(bias[:out].numpy(), 8))
    sd["backbone.upConv1dSkip.bias"] = bias[:out]
    back = convert_state_dict(sd, conf)
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=jax.tree_util.keystr(k))


def test_reference_key_names():
    keys = set(TransKun(ModelConfig.from_dict(TINY), device="cpu").module.state_dict())
    for k in [
        "framewiseFeatureExtractor.spectrogramExtractor.winGen.sigma",
        "framewiseFeatureExtractor.spectrogramExtractor.winGen.center",
        "backbone.inputConv.weight",
        "backbone.downConv.14.bias",
        "backbone.posEmbedBuilderAttnTE.mlp.3.weight",
        "backbone.encoderLayers.1.mhaBlockT.module.q_proj_weight",
        "backbone.encoderLayers.1.mhaBlockF.module.out_proj.bias",
        "backbone.encoderLayers.0.fnnBlockF.module.3.weight",
        "backbone.encoderLayers.0.fnnBlockT.scale",
        "backbone.upConv1dSkip.weight",
        "scorer.map.0.weight",
        "velocityPredictor.3.bias",
        "refinedOFPredictor.0.weight",
    ]:
        assert k in keys, k


def test_model_config_matches_jax_dataclass():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxModelConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    assert pf == jf
    assert load_default_conf()[1].to_dict() == jax_load_default_conf()[1].to_dict()


def test_port_imports_leave_jax_out():
    """Neither JAX nor any module of the JAX package, after every module of
    the port and ``chip_smoke.py`` are imported: the port keeps its own
    copies of the data, eval and dataset-build modules.  Run in a subprocess,
    since this test process imports ``transkun_tpu`` itself.  (Tiny CPU runs
    of the entry points under the same guard are in test_torch_data.py.)"""
    code = (
        "import importlib, pkgutil, sys\n"
        "import transkun_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(transkun_tpu_torch.__path__, 'transkun_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'transkun_tpu_torch.data.dataset' in sys.modules\n"
        "assert 'transkun_tpu_torch.ops.attention' in sys.modules\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'transkun_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
