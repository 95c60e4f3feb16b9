"""Flax-layout parameters -> PyTorch modules.

The JAX package's weights (random init, its training path, or the shipped
Keras ``.h5`` files) are nested dicts of arrays in Flax layout: conv
kernels ``(spatial..., in, out)``, Dense kernels ``(in, out)``.  PyTorch
wants ``(out, in, spatial...)`` and ``(out, in)``; the converters transpose
and nothing else.  The ``.h5`` readers are the port's own copy of
``caelo_tpu/models/weights_io.py``'s (numpy, with h5py imported when a file
is read): Keras stores the same layout as Flax, so reading is a renaming.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .patch_encoder import PatchEncoder
from .respond_net import RespondLayer


def _inner(params):
    return params["params"] if "params" in params else params


def _conv(kernel) -> torch.Tensor:
    """HWIO -> OIHW, DHWIO -> OIDHW."""
    k = np.asarray(kernel, np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))))


def _dense(kernel) -> torch.Tensor:
    """Dense (in, out) -> Linear (out, in)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).T))


def _bias(b) -> torch.Tensor:
    return torch.from_numpy(np.array(b, np.float32))


def respond_params_to_torch(params) -> dict:
    """Flax ``RespondLayer`` params -> ``RespondLayer`` state dict."""
    p = _inner(params)
    return {f"{name}.{field}": conv(p[name][key])
            for name in ("conv1_1", "conv1_1_2")
            for field, key, conv in (("weight", "kernel", _conv),
                                     ("bias", "bias", _bias))}


def encoder_params_to_torch(params) -> dict:
    """Flax ``PatchEncoder`` params -> ``PatchEncoder`` state dict.

    ``fn1``'s rows stay in Flax's channels-last flatten order: the torch
    module permutes its activations to NDHWC before flattening."""
    p = _inner(params)
    out = {}
    for name, conv in (("conv1", _conv), ("conv2", _conv), ("conv3", _conv),
                       ("fn1", _dense), ("fn2", _dense)):
        out[f"{name}.weight"] = conv(p[name]["kernel"])
        out[f"{name}.bias"] = _bias(p[name]["bias"])
    return out


def build_models(respond_params, encoder_params, device, cfg=None):
    """``(RespondLayer, PatchEncoder)`` in eval mode on ``device`` from Flax
    params; the encoder's activations come from ``cfg`` (a
    ``PipelineConfig``) when given."""
    respond = RespondLayer()
    respond.load_state_dict(respond_params_to_torch(respond_params))
    kw = {}
    if cfg is not None:
        kw = dict(activation=cfg.encoder_activation,
                  code_activation=cfg.encoder_code_activation)
    enc_sd = encoder_params_to_torch(encoder_params)
    encoder = PatchEncoder(code_dim=enc_sd["fn2.weight"].shape[0], **kw)
    encoder.load_state_dict(enc_sd)
    return respond.to(device).eval(), encoder.to(device).eval()


# the reference's TrainedModels directory; not part of the repository
REFERENCE_MODELS_DIR = os.environ.get("CAELO_REFERENCE_MODELS",
                                      "TrainedModels")


def _h5_layer_weights(path: str) -> Dict[str, list]:
    """Read {layer_name: [kernel, bias]} from a Keras .h5 in layer order."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        g = f["model_weights"]
        layer_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in g.attrs["layer_names"]
        ]
        for name in layer_names:
            lg = g[name]
            wnames = [
                n.decode() if isinstance(n, bytes) else n
                for n in lg.attrs.get("weight_names", [])
            ]
            if wnames:
                out[name] = [np.array(lg[w]) for w in wnames]
    return out


def load_respond_layer_params(path: str | None = None):
    """Shipped respond-layer weights -> Flax ``RespondLayer`` params."""
    path = path or os.path.join(
        REFERENCE_MODELS_DIR, "SphericalRingPCRespondLayer.h5"
    )
    w = _h5_layer_weights(path)
    convs = [n for n in w if n.startswith("conv")]
    assert len(convs) == 2, convs
    k1, b1 = w[convs[0]]
    k2, b2 = w[convs[1]]
    return {
        "params": {
            "conv1_1": {"kernel": k1, "bias": b1},
            "conv1_1_2": {"kernel": k2, "bias": b2},
        }
    }


def load_patch_encoder_params(path: str | None = None):
    """Shipped voxel-patch encoder weights -> Flax ``PatchEncoder`` params."""
    path = path or os.path.join(
        REFERENCE_MODELS_DIR, "EncoderModel4VoxelPatch.h5"
    )
    w = _h5_layer_weights(path)
    convs = sorted([n for n in w if n.startswith("conv3d")])
    denses = sorted([n for n in w if n.startswith("dense")])
    assert len(convs) == 3 and len(denses) == 2, (convs, denses)
    params = {}
    for flax_name, h5_name in zip(["conv1", "conv2", "conv3"], convs):
        k, b = w[h5_name]
        params[flax_name] = {"kernel": k, "bias": b}
    for flax_name, h5_name in zip(["fn1", "fn2"], denses):
        k, b = w[h5_name]
        params[flax_name] = {"kernel": k, "bias": b}
    return {"params": params}


def reference_models_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return os.path.isdir(REFERENCE_MODELS_DIR)


def load_reference_models(device, cfg=None):
    """The shipped reference weights (``TrainedModels/*.h5``, from
    ``REFERENCE_MODELS_DIR`` or the ``CAELO_REFERENCE_MODELS`` environment
    variable) as torch modules."""
    if not reference_models_available():
        raise FileNotFoundError(
            f"reference models not found in {REFERENCE_MODELS_DIR}")
    return build_models(load_respond_layer_params(),
                        load_patch_encoder_params(), device, cfg)


def random_flax_params(seed: int = 0, code_dim: int = 20):
    """Flax-layout numpy params for both models at lecun-normal scale
    (std = 1/sqrt(fan_in), zero biases), made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)

    def layer(*shape):
        fan_in = int(np.prod(shape[:-1]))
        k = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape).astype(np.float32)
        return {"kernel": k, "bias": np.zeros(shape[-1], np.float32)}

    respond = {"params": {"conv1_1": layer(3, 3, 3, 32),
                          "conv1_1_2": layer(1, 1, 32, 8)}}
    encoder = {"params": {"conv1": layer(3, 3, 3, 1, 8),
                          "conv2": layer(3, 3, 3, 8, 16),
                          "conv3": layer(3, 3, 3, 16, 32),
                          "fn1": layer(2048, 200),
                          "fn2": layer(200, code_dim)}}
    return respond, encoder
