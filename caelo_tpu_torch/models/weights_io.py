"""Flax-layout parameters -> PyTorch modules.

The JAX package's weights (random init, its training path, or the shipped
Keras ``.h5`` files through ``caelo_tpu.models.weights_io``) are nested
dicts of arrays in Flax layout: conv kernels ``(spatial..., in, out)``,
Dense kernels ``(in, out)``.  PyTorch wants ``(out, in, spatial...)`` and
``(out, in)``; the converters transpose and nothing else.
"""
from __future__ import annotations

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


def load_reference_models(device, cfg=None):
    """The shipped reference weights (``TrainedModels/*.h5``), read by the
    JAX package's loaders (numpy + h5py, no JAX), as torch modules."""
    from caelo_tpu.models import weights_io as flax_weights_io

    if not flax_weights_io.reference_models_available():
        raise FileNotFoundError(
            f"reference models not found in {flax_weights_io.REFERENCE_MODELS_DIR}")
    return build_models(flax_weights_io.load_respond_layer_params(),
                        flax_weights_io.load_patch_encoder_params(), device, cfg)


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
