"""Flax-layout parameters -> PyTorch modules, and the port's checkpoints.

The JAX package's weights (random init, its training path, or the shipped
Keras ``.h5`` files) are nested dicts of arrays in Flax layout: conv
kernels ``(spatial..., in, out)``, Dense kernels ``(in, out)``.  PyTorch
wants ``(out, in, spatial...)`` and ``(out, in)``; the converters transpose
and nothing else.  The ``.h5`` readers are the port's own copy of
``caelo_tpu/models/weights_io.py``'s (numpy, with h5py imported when a file
is read): Keras stores the same layout as Flax, so reading is a renaming.

Checkpoints are ``torch.save`` of a state dict under ``<path>/<step>/``
(the JAX package writes orbax checkpoints there, which the port does not
read); ``*_ae_params_from_torch`` carry a trained auto-encoder's state dict
back to Flax-layout numpy params, which the JAX package runs.
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
    return _convert(_inner(params), [("conv1_1", _conv), ("conv1_1_2", _conv)])


def encoder_params_to_torch(params) -> dict:
    """Flax ``PatchEncoder`` params -> ``PatchEncoder`` state dict.

    ``fn1``'s rows stay in Flax's channels-last flatten order: the torch
    module permutes its activations to NDHWC before flattening."""
    return _convert(_inner(params), [
        ("conv1", _conv), ("conv2", _conv), ("conv3", _conv),
        ("fn1", _dense), ("fn2", _dense)])


def _convert(params, layers) -> dict:
    """State-dict entries of the Flax ``layers``, ``(name, kernel
    converter)`` pairs."""
    out = {}
    for name, conv in layers:
        out[f"{name}.weight"] = conv(params[name]["kernel"])
        out[f"{name}.bias"] = _bias(params[name]["bias"])
    return out


def spherical_ae_params_to_torch(params) -> dict:
    """Flax ``SphericalRingAE`` params -> ``SphericalRingAE`` state dict."""
    p = _inner(params)
    out = {f"respond.{k}": v
           for k, v in respond_params_to_torch(p["respond"]).items()}
    out.update(_convert(p, [(n, _conv) for n in
                            ("conv1_2", "conv2_2", "conv2_3", "out")]))
    return out


def voxel_ae_params_to_torch(params) -> dict:
    """Flax ``VoxelPatchAE`` params -> ``VoxelPatchAE`` state dict.  ``fn4``'s
    columns stay in Flax's channels-last order: the torch module reshapes
    them channels-last before it permutes to NCDHW."""
    p = _inner(params)
    out = {f"encoder.{k}": v
           for k, v in encoder_params_to_torch(p["encoder"]).items()}
    out.update(_convert(p, [("fn3", _dense), ("fn4", _dense),
                            ("conv2_1", _conv), ("conv2_2", _conv),
                            ("out", _conv)]))
    return out


def _to_flax(state_dict, layers) -> dict:
    """The Flax ``{name: {"kernel", "bias"}}`` numpy layers of a state
    dict, ``layers`` ``(name, is_conv)`` pairs: the converters' inverses
    (OI... -> ...IO, Linear (out, in) -> Dense (in, out))."""
    out = {}
    for name, is_conv in layers:
        w = state_dict[f"{name}.weight"].detach().cpu().numpy()
        k = (w.transpose(*range(2, w.ndim), 1, 0) if is_conv else w.T)
        out[name] = {"kernel": np.ascontiguousarray(k),
                     "bias": state_dict[f"{name}.bias"].detach().cpu().numpy()}
    return out


def spherical_ae_params_from_torch(state_dict) -> dict:
    """``SphericalRingAE`` state dict -> Flax ``SphericalRingAE`` params
    (numpy), the inverse of ``spherical_ae_params_to_torch``."""
    p = _to_flax(state_dict, [(n, True) for n in
                              ("conv1_2", "conv2_2", "conv2_3", "out")])
    p["respond"] = _to_flax(_submodule(state_dict, "respond"),
                            [("conv1_1", True), ("conv1_1_2", True)])
    return {"params": p}


def voxel_ae_params_from_torch(state_dict) -> dict:
    """``VoxelPatchAE`` state dict -> Flax ``VoxelPatchAE`` params (numpy),
    the inverse of ``voxel_ae_params_to_torch``."""
    p = _to_flax(state_dict, [("fn3", False), ("fn4", False),
                              ("conv2_1", True), ("conv2_2", True),
                              ("out", True)])
    p["encoder"] = _to_flax(_submodule(state_dict, "encoder"), [
        ("conv1", True), ("conv2", True), ("conv3", True), ("fn1", False),
        ("fn2", False)])
    return {"params": p}


def _submodule(state_dict, name: str) -> dict:
    return {k[len(name) + 1:]: v for k, v in state_dict.items()
            if k.startswith(name + ".")}


def respond_params_from_ae(ae_state_dict) -> dict:
    """The ``RespondLayer`` state dict inside a (trained)
    ``SphericalRingAE`` state dict: its ``respond`` submodule, the
    reference's RespondLayer submodel split (``AE4SphericalRingPC.py:145``)."""
    return _submodule(ae_state_dict, "respond")


def encoder_params_from_ae(ae_state_dict) -> dict:
    """The ``PatchEncoder`` state dict inside a (trained) ``VoxelPatchAE``
    state dict: its ``encoder`` submodule (``AE4VoxelPatch.py:210``).  Run
    inference with ``PipelineConfig(encoder_activation='relu',
    encoder_code_activation='linear')`` to match the training recipe."""
    return _submodule(ae_state_dict, "encoder")


def build_models_from_state_dicts(respond_sd, encoder_sd, device, cfg=None):
    """``(RespondLayer, PatchEncoder)`` in eval mode on ``device`` from
    torch state dicts; the encoder's activations come from ``cfg`` (a
    ``PipelineConfig``) when given."""
    respond = RespondLayer()
    respond.load_state_dict(respond_sd)
    kw = {}
    if cfg is not None:
        kw = dict(activation=cfg.encoder_activation,
                  code_activation=cfg.encoder_code_activation)
    encoder = PatchEncoder(code_dim=encoder_sd["fn2.weight"].shape[0], **kw)
    encoder.load_state_dict(encoder_sd)
    return respond.to(device).eval(), encoder.to(device).eval()


def build_models(respond_params, encoder_params, device, cfg=None):
    """``(RespondLayer, PatchEncoder)`` in eval mode on ``device`` from Flax
    params; the encoder's activations come from ``cfg`` (a
    ``PipelineConfig``) when given."""
    return build_models_from_state_dicts(
        respond_params_to_torch(respond_params),
        encoder_params_to_torch(encoder_params), device, cfg)


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


def load_spherical_ae_params(path: str | None = None):
    """Shipped full 2D auto-encoder (``TrainedModels/AE4SphericalRingPC.h5``:
    6 convs, relu x5 + linear out) -> Flax ``SphericalRingAE`` params."""
    path = path or os.path.join(REFERENCE_MODELS_DIR, "AE4SphericalRingPC.h5")
    w = _h5_layer_weights(path)
    convs = sorted(
        [n for n in w if n.startswith("conv2d")],
        key=lambda n: int(n.split("_")[-1]),
    )
    assert len(convs) == 6, convs
    flax_names = [
        ("respond", "conv1_1"), ("respond", "conv1_1_2"),
        ("conv1_2",), ("conv2_2",), ("conv2_3",), ("out",),
    ]
    params: dict = {}
    for names, h5n in zip(flax_names, convs):
        k, b = w[h5n]
        node = params
        for part in names[:-1]:
            node = node.setdefault(part, {})
        node[names[-1]] = {"kernel": k, "bias": b}
    return {"params": params}


def load_voxel_ae_params(path: str | None = None):
    """Shipped full 3D auto-encoder
    (``TrainedModels/AutoencoderModel4VoxelPatch.h5``: relu convs/denses,
    linear 20-dim code, sigmoid out -- matching the training script, unlike
    the tanh encoder-only artifact) -> Flax ``VoxelPatchAE`` params.

    Use with ``VoxelPatchAE(activation='relu', code_activation='linear')``.
    """
    path = path or os.path.join(
        REFERENCE_MODELS_DIR, "AutoencoderModel4VoxelPatch.h5"
    )
    w = _h5_layer_weights(path)
    convs = sorted(
        [n for n in w if n.startswith("conv3d")],
        key=lambda n: int(n.split("_")[-1]),
    )
    denses = sorted(
        [n for n in w if n.startswith("dense")],
        key=lambda n: int(n.split("_")[-1]),
    )
    assert len(convs) == 6 and len(denses) == 4, (convs, denses)
    enc = {}
    for fx, h5n in zip(["conv1", "conv2", "conv3"], convs[:3]):
        k, b = w[h5n]
        enc[fx] = {"kernel": k, "bias": b}
    for fx, h5n in zip(["fn1", "fn2"], denses[:2]):
        k, b = w[h5n]
        enc[fx] = {"kernel": k, "bias": b}
    params = {"encoder": enc}
    for fx, h5n in zip(["fn3", "fn4"], denses[2:]):
        k, b = w[h5n]
        params[fx] = {"kernel": k, "bias": b}
    for fx, h5n in zip(["conv2_1", "conv2_2", "out"], convs[3:]):
        k, b = w[h5n]
        params[fx] = {"kernel": k, "bias": b}
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


def _layer_fn(rng):
    """A Flax-layout layer of ``shape`` at lecun-normal scale (std =
    1/sqrt(fan_in), zero bias), drawn from ``rng``."""
    def layer(*shape):
        fan_in = int(np.prod(shape[:-1]))
        k = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape).astype(np.float32)
        return {"kernel": k, "bias": np.zeros(shape[-1], np.float32)}
    return layer


def random_flax_params(seed: int = 0, code_dim: int = 20):
    """Flax-layout numpy params for both models at lecun-normal scale
    (std = 1/sqrt(fan_in), zero biases), made from ``seed`` with numpy."""
    layer = _layer_fn(np.random.default_rng(seed))
    respond = {"params": {"conv1_1": layer(3, 3, 3, 32),
                          "conv1_1_2": layer(1, 1, 32, 8)}}
    encoder = {"params": {"conv1": layer(3, 3, 3, 1, 8),
                          "conv2": layer(3, 3, 3, 8, 16),
                          "conv3": layer(3, 3, 3, 16, 32),
                          "fn1": layer(2048, 200),
                          "fn2": layer(200, code_dim)}}
    return respond, encoder


def random_ae_params(seed: int = 0, code_dim: int = 20):
    """Flax-layout numpy params of both auto-encoders, ``(SphericalRingAE,
    VoxelPatchAE)``, at lecun-normal scale, made from ``seed`` with numpy:
    the trainers' initial weights."""
    layer = _layer_fn(np.random.default_rng(seed))
    respond, encoder = random_flax_params(seed + 1, code_dim)
    spherical = {"params": {"respond": respond["params"],
                            "conv1_2": layer(3, 3, 8, 16),
                            "conv2_2": layer(3, 3, 16, 16),
                            "conv2_3": layer(3, 3, 16, 8),
                            "out": layer(1, 1, 8, 3)}}
    voxel = {"params": {"encoder": encoder["params"],
                        "fn3": layer(code_dim, 200),
                        "fn4": layer(200, 2048),
                        "conv2_1": layer(3, 3, 3, 32, 16),
                        "conv2_2": layer(3, 3, 3, 16, 8),
                        "out": layer(3, 3, 3, 8, 1)}}
    return spherical, voxel


def save_checkpoint(path: str, state_dict, step: int = 0) -> str:
    """``torch.save`` a state dict to ``<path>/<step>/state_dict.pt``
    (replaces Keras ``.h5`` saves, ``AE4SphericalRingPC.py:169-170``);
    tensors are saved from the CPU.  Returns the file written."""
    d = os.path.join(os.path.abspath(path), str(step))
    os.makedirs(d, exist_ok=True)
    f = os.path.join(d, "state_dict.pt")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, f)
    return f


def load_checkpoint(path: str, step: int = 0) -> dict:
    """The state dict ``save_checkpoint`` wrote, on the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), str(step),
                                   "state_dict.pt"),
                      map_location="cpu", weights_only=True)


def load_trained(path: str):
    """``(respond_sd, encoder_sd)``: the respond layer and patch encoder of
    the auto-encoders ``train_from_scratch_study`` saved under ``path``
    (``<path>/respond_ae``, ``<path>/patch_ae``)."""
    return (respond_params_from_ae(load_checkpoint(
                os.path.join(path, "respond_ae"))),
            encoder_params_from_ae(load_checkpoint(
                os.path.join(path, "patch_ae"))))
