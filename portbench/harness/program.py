"""The system under test: ``larynx_tpu_torch``'s synthesis engine, built from
a configuration file and the benchmark's weights, with each model's config
class named by its kind (``kinds/<kind>.py``'s ``PORT_CONFIG``).  This is
the only module of the benchmark that imports the port."""

import dataclasses
import importlib

import torch

from portbench import kinds

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _port_config(kind, spec):
    """The port's config object of a model kind from the configuration's
    entries that the class has (lists as tuples)."""
    module, name = kinds.load(kind).PORT_CONFIG.split(":")
    cls = getattr(importlib.import_module(module), name)
    names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for k, v in spec.items():
        if k in names:
            out[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v) \
                if isinstance(v, list) else v
    return cls(**out)


def build_engine(config, acoustic_params, voc_params, engine_seed, device):
    """A ``SynthesisEngine`` at the configuration's precision; raises when
    the engine would run another precision than the configuration states."""
    from larynx_tpu_torch.audio import AudioSettings
    from larynx_tpu_torch.runtime.engine import SynthesisEngine

    acfg, voc = config["acoustic"], config["vocoder"]
    engine = SynthesisEngine(
        acoustic_params, _port_config(acfg["kind"], acfg), AudioSettings(**config["audio"]),
        vocoder_kind=voc["kind"], vocoder_params=voc_params,
        vocoder_cfg=_port_config(voc["kind"], voc), seed=engine_seed, device=device,
        **kinds.load(voc["kind"]).engine_kwargs(voc))
    prec = config["precision"]
    want_voc = DTYPES[prec["vocoder"]] if device.type == "cuda" else torch.float32
    if engine.voc_dtype != want_voc or engine.dtype != DTYPES[prec["acoustic"]]:
        raise RuntimeError(f"the engine runs the acoustic model in {engine.dtype} and the "
                           f"vocoder in {engine.voc_dtype}; the configuration states {prec}")
    return engine
