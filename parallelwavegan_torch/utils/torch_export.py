"""Generator parameter trees -> reference PyTorch state_dicts and ``.pkl``.

Counterpart of ``parallelwavegan_tpu/utils/torch_export.py`` for the
generators the port has (Parallel WaveGAN, MelGAN, HiFi-GAN, StyleMelGAN,
VQ-VAE, UHiFiGAN and the four discrete-symbol generators): the inverse of ``utils/torch_import.py``. The reference
toolkit (or ESPnet) loads the ``.pkl`` through its ``utils.load_model``,
which reads ``ckpt["model"]["generator"]`` and the config beside it. The
tree is flax-style, nested dicts of numpy arrays or tensors: a converted
flax tree, or ``utils.params.nested(module.state_dict())``.

Layout conversions (flax -> torch) invert the importer's:
  Conv1d  kernel (K, I/g, O)    -> weight (O, I/g, K)     transpose(2, 1, 0)
  ConvT1d kernel (K, I, O)      -> weight (I, O, K)       transpose(1, 2, 0)
  Conv2d  kernel (Kh, Kw, I, O) -> weight (O, I, Kh, Kw)  transpose(3, 2, 0, 1)
  kernel_g (1, ..., O)          -> weight_g (O, 1, ...)   [ConvT1d: (I, 1, 1)]
  a folded kernel under use_weight_norm -> weight_v = w, weight_g = ||w||
    (torch folds w = g v / ||v||, so that pair gives w back)
  embedding (N, D)              -> Embedding weight (N, D)  as it is
  Dense kernel (I, O)           -> Linear weight (O, I)   (never weight-normed)
  LayerNorm scale, bias         -> weight, bias
  the F0 generator's input conv -> a plain ``weight`` (the reference never
    weight-norms it); a bare top-level ``weights`` stays at the top
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

from parallelwavegan_torch.utils.torch_import import _melgan_sequential_map


def _pwg_generator_inverse(config: Dict[str, Any]):
    upsample_params = config.get("upsample_params", {}) or {}
    step = 3 if upsample_params.get("nonlinear_activation") is not None else 2

    def rule(path: str):
        if path == "first_conv":
            return "first_conv", "conv1d"
        if path == "upsample_net/conv_in":
            return "upsample_net.conv_in", "conv1d"
        m = re.match(r"^upsample_net/upsample/conv_(\d+)$", path)
        if m:
            return (f"upsample_net.upsample.up_layers."
                    f"{1 + int(m.group(1)) * step}", "conv2d")
        m = re.match(r"^upsample_net/conv_(\d+)$", path)
        if m:
            return (f"upsample_net.up_layers.{1 + int(m.group(1)) * step}",
                    "conv2d")
        m = re.match(
            r"^conv_layers_(\d+)/(conv|conv1x1_aux|conv1x1_skip|conv1x1_out)$",
            path)
        if m:
            return f"conv_layers.{m.group(1)}.{m.group(2)}", "conv1d"
        m = re.match(r"^last_conv_(\d+)$", path)
        if m:
            return f"last_conv_layers.{1 + 2 * int(m.group(1))}", "conv1d"
        return None

    return rule


def _melgan_generator_inverse(config: Dict[str, Any]):
    inv = {ours: (key, kind)
           for key, (ours, kind) in _melgan_sequential_map(config).items()}
    return inv.get


def _hifigan_generator_inverse(config: Dict[str, Any]):
    causal = config.get("use_causal_conv", False)

    def rule(path: str):
        if path == "input_conv" and not causal:
            return "input_conv", "conv1d"
        if path == "input_conv/conv":
            return "input_conv.conv", "conv1d"
        m = re.match(r"^upsamples_(\d+)$", path)
        if m:
            return f"upsamples.{m.group(1)}.1", "convt1d"
        m = re.match(r"^upsamples_(\d+)/deconv$", path)
        if m:
            return f"upsamples.{m.group(1)}.1.deconv", "convt1d"
        m = re.match(r"^blocks_(\d+)/(convs1|convs2)_(\d+)(/conv)?$", path)
        if m:
            tail = ".conv" if m.group(4) else ""
            return (f"blocks.{m.group(1)}.{m.group(2)}.{m.group(3)}.1{tail}",
                    "conv1d")
        if path == "output_conv" and not causal:
            return "output_conv.1", "conv1d"
        if path == "output_conv/conv":
            return "output_conv.1.conv", "conv1d"
        return None

    return rule


def _style_melgan_generator_inverse(config: Dict[str, Any]):
    def rule(path: str):
        m = re.match(r"^noise_upsample_(\d+)$", path)
        if m:
            return f"noise_upsample.{2 * int(m.group(1))}", "convt1d"
        m = re.match(r"^blocks_(\d+)/(tade1|tade2)/(aux_conv|gated_conv)$",
                     path)
        if m:
            return (f"blocks.{m.group(1)}.{m.group(2)}.{m.group(3)}.0",
                    "conv1d")
        m = re.match(r"^blocks_(\d+)/(gated_conv1|gated_conv2)$", path)
        if m:
            return f"blocks.{m.group(1)}.{m.group(2)}", "conv1d"
        if path == "output_conv":
            return "output_conv.0", "conv1d"
        return None

    return rule


def _vqvae_inverse(config: Dict[str, Any]):
    """VQVAE's inverse map. The encoder tower's first conv sits in a
    Sequential(pad, conv) (``.1``), the downsampling convs and the one
    before the output in Sequential(conv, act) (``.0``), the output conv
    bare; as the JAX exporter, the tower's length comes from
    ``encoder_conf``'s ``downsample_scales`` (four by default)."""
    dec_inv = _melgan_generator_inverse(config.get("decoder_conf", {}) or {})
    encoder_conf = config.get("encoder_conf", {}) or {}
    n_enc = len(encoder_conf.get("downsample_scales", (4, 4, 4, 4))) + 3

    def rule(path: str):
        if path == "codebook":
            return "codebook.embedding", "embedding"
        if path == "local_embed":
            return "local_embed", "conv1d"
        if path == "global_embed":
            return "global_embed", "embedding"
        m = re.match(r"^encoder/layer_(\d+)$", path)
        if m:
            i = int(m.group(1))
            suffix = ".1" if i == 0 else ("" if i == n_enc - 1 else ".0")
            return f"encoder.layers.{i}{suffix}", "conv1d"
        if path.startswith("decoder/"):
            sub = dec_inv(path[len("decoder/"):])
            if sub:
                return f"decoder.{sub[0]}", sub[1]
        return None

    return rule


def _uhifigan_generator_inverse(config: Dict[str, Any]):
    """UHiFiGAN's inverse map: the input and the downsampling convs sit at
    index 0 of their reference Sequential, the transposed convs, the
    residual blocks' convs and the output conv at index 1."""
    def rule(path: str):
        if path == "input_conv":
            return "input_conv.0", "conv1d"
        if path == "hidden_conv":
            return "hidden_conv", "conv1d"
        if path == "output_conv":
            return "output_conv.1", "conv1d"
        m = re.match(r"^downsamples_(\d+)$", path)
        if m:
            return f"downsamples.{m.group(1)}.0", "conv1d"
        m = re.match(r"^upsamples_(\d+)$", path)
        if m:
            return f"upsamples.{m.group(1)}.1", "convt1d"
        m = re.match(r"^(downsamples_mrf|upsamples_mrf)_(\d+)/"
                     r"(convs1|convs2)_(\d+)$", path)
        if m:
            return (f"{m.group(1)}.{m.group(2)}.{m.group(3)}.{m.group(4)}.1",
                    "conv1d")
        return None

    return rule


def _token_embed_inverse(config: Dict[str, Any]):
    def rule(path: str):
        if path in ("emb", "spk_emb"):
            return path, "embedding"
        m = re.match(r"^emb_(\d+)$", path)
        if m:
            return f"emb.{m.group(1)}", "embedding"
        return None

    return rule


def _with_trunk(token_rule, trunk_rule):
    """The token tables, then the trunk's paths under ``trunk/``."""
    def rule(path: str):
        sub = token_rule(path)
        if sub:
            return sub
        if path.startswith("trunk/"):
            return trunk_rule(path[len("trunk/"):])
        return None

    return rule


def _discrete_hifigan_inverse(config: Dict[str, Any]):
    return _with_trunk(_token_embed_inverse(config),
                       _hifigan_generator_inverse(config))


def _discrete_duration_inverse(config: Dict[str, Any]):
    base = _discrete_hifigan_inverse(config)

    def rule(path: str):
        m = re.match(r"^duration_predictor/conv_(\d+)$", path)
        if m:
            return f"duration_predictor.conv.{m.group(1)}.0", "conv1d"
        m = re.match(r"^duration_predictor/norm_(\d+)$", path)
        if m:
            return f"duration_predictor.conv.{m.group(1)}.2", "norm"
        if path == "duration_predictor/linear":
            return "duration_predictor.linear", "dense"
        return base(path)

    return rule


def _discrete_f0_inverse(config: Dict[str, Any]):
    base = _discrete_hifigan_inverse(config)

    def rule(path: str):
        if path == "f0_embedding":
            return "f0_embedding", "dense"
        if path == "weights":
            return "weights", "param"
        if path == "trunk/input_conv":
            return "input_conv", "conv1d_plain"
        return base(path)

    return rule


def _discrete_style_melgan_inverse(config: Dict[str, Any]):
    return _with_trunk(_token_embed_inverse(config),
                       _style_melgan_generator_inverse(config))


_INVERSE_RULES = {
    "ParallelWaveGANGenerator": _pwg_generator_inverse,
    "MelGANGenerator": _melgan_generator_inverse,
    "HiFiGANGenerator": _hifigan_generator_inverse,
    "StyleMelGANGenerator": _style_melgan_generator_inverse,
    "VQVAE": _vqvae_inverse,
    "UHiFiGANGenerator": _uhifigan_generator_inverse,
    "DiscreteSymbolHiFiGANGenerator": _discrete_hifigan_inverse,
    "DiscreteSymbolDurationGenerator": _discrete_duration_inverse,
    "DiscreteSymbolF0Generator": _discrete_f0_inverse,
    "DiscreteSymbolStyleMelGANGenerator": _discrete_style_melgan_inverse,
}
_INV_PERMS = {"conv1d": (2, 1, 0), "convt1d": (1, 2, 0),
              "conv2d": (3, 2, 0, 1), "dense": (1, 0)}


def _array(x: Any) -> np.ndarray:
    """A leaf (numpy array or tensor, bf16 included) as float32 numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _g_to_torch(kind: str, g: np.ndarray) -> np.ndarray:
    """kernel_g (1, ..., C) -> torch's weight_g (C, 1, ...)."""
    flat = np.asarray(g).reshape(-1)
    ndim = {"conv1d": 3, "convt1d": 3, "conv2d": 4}[kind]
    return flat.reshape((flat.shape[0],) + (1,) * (ndim - 1))


def _leaf_to_torch(kind: str, leaves: Dict[str, np.ndarray],
                   use_weight_norm: bool) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if kind == "embedding":  # flax's nn.Embed table, as nn.Embedding's
        return {"weight": leaves["embedding"]}
    if kind == "norm":  # the dim-selectable LayerNorm: scale -> weight
        out = {"weight": leaves["scale"]}
        if "bias" in leaves:
            out["bias"] = leaves["bias"]
        return out
    if kind in ("conv1d_plain", "dense"):
        # a conv the reference never weight-norms; a Linear
        kind = "conv1d" if kind == "conv1d_plain" else kind
        use_weight_norm = False
    perm = _INV_PERMS[kind]
    if "kernel_v" in leaves:
        out["weight_v"] = leaves["kernel_v"].transpose(perm)
        out["weight_g"] = _g_to_torch(kind, leaves["kernel_g"])
    elif "kernel" in leaves:
        w = leaves["kernel"].transpose(perm)
        if use_weight_norm:
            # a (v, g) pair for torch's weight norm over dim 0 (for a
            # ConvT1d's (I, O, K) weight that is the input channel)
            out["weight_v"] = w
            out["weight_g"] = np.sqrt(np.sum(
                np.square(w), axis=tuple(range(1, w.ndim)), keepdims=True))
        else:
            out["weight"] = w
    if "bias" in leaves:
        out["bias"] = leaves["bias"]
    return out


def _flatten(tree: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """A parameter tree as {path: {leaf name: float32 array}}."""
    out: Dict[str, Dict[str, np.ndarray]] = {}

    def rec(node: Dict[str, Any], path: str) -> None:
        leaves = {}
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, f"{path}/{k}" if path else k)
            else:
                leaves[k] = _array(v)
        if leaves:
            out[path] = leaves

    rec(dict(tree), "")
    return out


def export_generator_state_dict(
    params: Dict[str, Any],
    model_name: str,
    config: Dict[str, Any],
) -> Dict[str, np.ndarray]:
    """A generator's parameter tree -> the reference's state_dict (numpy,
    float32). ``config`` is the experiment config or its
    ``generator_params``."""
    if model_name not in _INVERSE_RULES:
        raise NotImplementedError(
            f"no torch-export rules for {model_name}; exportable: "
            f"{sorted(_INVERSE_RULES)}")
    gen_params = config.get("generator_params", config) or {}
    rule = _INVERSE_RULES[model_name](gen_params)
    use_wn = gen_params.get("use_weight_norm", True)
    state: Dict[str, np.ndarray] = {}
    for path, leaves in sorted(_flatten(params).items()):
        if path == "":
            # bare top-level parameters (the F0 generator's ``weights``)
            for leaf, value in leaves.items():
                mapped = rule(leaf)
                if mapped is None or mapped[1] != "param":
                    raise KeyError(f"torch-export: no reference location "
                                   f"for top-level param '{leaf}' of "
                                   f"{model_name}")
                state[mapped[0]] = np.asarray(value, dtype=np.float32)
            continue
        mapped = rule(path)
        if mapped is None:
            raise KeyError(f"torch-export: no reference location for param "
                           f"'{path}' of {model_name}")
        prefix, kind = mapped
        for leaf, tensor in _leaf_to_torch(kind, leaves, use_wn).items():
            state[f"{prefix}.{leaf}"] = np.asarray(tensor, dtype=np.float32)
    return state


def save_reference_checkpoint(
    path: str,
    params: Dict[str, Any],
    config: Dict[str, Any],
    steps: int = 0,
) -> None:
    """Write a ``checkpoint-<N>steps.pkl`` the reference toolkit loads: its
    ``utils.load_model`` reads ``ckpt["model"]["generator"]``, its trainer
    also ``steps`` and ``epochs``."""
    import torch

    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    state = export_generator_state_dict(params, gen_type, config)
    torch.save({
        "model": {"generator": {k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in state.items()}},
        "steps": steps,
        "epochs": 0,
    }, path)
