"""Reference PyTorch state_dicts -> flax-style parameter trees.

Counterpart of ``parallelwavegan_tpu/utils/torch_import.py`` for the
families the port has: it reads the reference toolkit's
``checkpoint-<N>steps.pkl`` and gives the tree the JAX importer gives
(nested dicts of float32 numpy arrays under the flax names), which
``utils/params.convert_jax_params`` turns into the port's state_dicts.
Discriminator rules are name maps only.

Layout conversions (torch -> flax):
  Conv1d  weight (O, I/g, K)    -> kernel (K, I/g, O)     transpose(2, 1, 0)
  ConvT1d weight (I, O/g, K)    -> kernel (K, I, O)       transpose(2, 0, 1)
  Conv2d  weight (O, I, Kh, Kw) -> kernel (Kh, Kw, I, O)  transpose(2, 3, 1, 0)
  weight_g (O, 1, ...)          -> kernel_g (1, ..., O)   [ConvT1d: (1, I, 1)]
  spectral-norm weight_orig     -> kernel; weight_u -> the spectral collection
  Embedding weight (N, D)       -> embedding (N, D)       as it is
  Linear  weight (O, I)         -> kernel (I, O)          transpose(1, 0)
  LayerNorm weight, bias        -> scale, bias
  a bare top-level parameter    -> the same name at the tree's top
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

Rule = Callable[[str], Optional[Tuple[str, str]]]

def _melgan_sequential_map(config: Dict[str, Any]
                           ) -> Dict[str, Tuple[str, str]]:
    """MelGANGenerator's torch Sequential indices -> ``layer_<i>`` paths."""
    scales = list(config.get("upsample_scales", [8, 8, 2, 2]))
    stacks = config.get("stacks", 3)
    causal = config.get("use_causal_conv", False)
    out: Dict[str, Tuple[str, str]] = {}
    li = ti = 0
    if not causal:
        ti += 1  # pad
        out[f"melgan.{ti}"] = (f"layer_{li}", "conv1d")
    else:
        out[f"melgan.{ti}.conv"] = (f"layer_{li}/conv", "conv1d")
    ti += 1
    li += 1
    for _ in scales:
        ti += 1  # act
        if not causal:
            out[f"melgan.{ti}"] = (f"layer_{li}", "convt1d")
        else:
            out[f"melgan.{ti}.deconv"] = (f"layer_{li}/deconv", "convt1d")
        ti += 1
        li += 1
        for _ in range(stacks):
            base = f"melgan.{ti}"
            if not causal:
                out[f"{base}.stack.2"] = (f"layer_{li}/conv_dilated", "conv1d")
                out[f"{base}.stack.4"] = (f"layer_{li}/conv1x1", "conv1d")
            else:
                out[f"{base}.stack.1.conv"] = (
                    f"layer_{li}/conv_dilated/conv", "conv1d")
                out[f"{base}.stack.3"] = (f"layer_{li}/conv1x1", "conv1d")
            out[f"{base}.skip_layer"] = (f"layer_{li}/skip_layer", "conv1d")
            ti += 1
            li += 1
    ti += 1  # act
    if not causal:
        ti += 1  # pad
        out[f"melgan.{ti}"] = (f"layer_{li}", "conv1d")
    else:
        out[f"melgan.{ti}.conv"] = (f"layer_{li}/conv", "conv1d")
    return out


def _melgan_discriminator_rules() -> Rule:
    def rule(key):
        m = re.match(r"^layers\.(\d+)(?:\.\d+)?$", key)
        if m:
            return f"layer_{m.group(1)}", "conv1d"
        return None

    return rule


def _pwg_generator_rule(config) -> Rule:
    upsample_params = config.get("upsample_params", {}) or {}
    step = 3 if upsample_params.get("nonlinear_activation") is not None else 2

    def rule(key):
        if key == "first_conv":
            return "first_conv", "conv1d"
        if key == "upsample_net.conv_in":
            return "upsample_net/conv_in", "conv1d"
        m = re.match(r"^upsample_net\.upsample\.up_layers\.(\d+)$", key)
        if m:
            i = int(m.group(1))
            return f"upsample_net/upsample/conv_{(i - 1) // step}", "conv2d"
        m = re.match(r"^upsample_net\.up_layers\.(\d+)$", key)
        if m:
            i = int(m.group(1))
            return f"upsample_net/conv_{(i - 1) // step}", "conv2d"
        m = re.match(
            r"^conv_layers\.(\d+)\.(conv|conv1x1_aux|conv1x1_skip|conv1x1_out)$",
            key)
        if m:
            return f"conv_layers_{m.group(1)}/{m.group(2)}", "conv1d"
        m = re.match(r"^last_conv_layers\.(\d+)$", key)
        if m:
            return f"last_conv_{(int(m.group(1)) - 1) // 2}", "conv1d"
        return None

    return rule


def _pwg_discriminator_rule(config) -> Rule:
    layers = config.get("layers", 10)

    def rule(key):
        m = re.match(r"^conv_layers\.(\d+)$", key)
        if m:
            i = int(m.group(1)) // 2
            if i >= layers - 1:
                return "last_conv", "conv1d"
            return f"conv_{i}", "conv1d"
        return None

    return rule


def _rpwg_discriminator_rule(config) -> Rule:
    def rule(key):
        if key == "first_conv.0":
            return "first_conv", "conv1d"
        m = re.match(
            r"^conv_layers\.(\d+)\.(conv|conv1x1_aux|conv1x1_skip|conv1x1_out)$",
            key)
        if m:
            return f"conv_layers_{m.group(1)}/{m.group(2)}", "conv1d"
        m = re.match(r"^last_conv_layers\.(\d+)$", key)
        if m:
            return f"last_conv_{(int(m.group(1)) - 1) // 2}", "conv1d"
        return None

    return rule


def _hifigan_generator_rule(config) -> Rule:
    def rule(key):
        if key == "input_conv":
            return "input_conv", "conv1d"
        if key == "input_conv.conv":
            return "input_conv/conv", "conv1d"
        m = re.match(r"^upsamples\.(\d+)\.1$", key)
        if m:
            return f"upsamples_{m.group(1)}", "convt1d"
        m = re.match(r"^upsamples\.(\d+)\.1\.deconv$", key)
        if m:
            return f"upsamples_{m.group(1)}/deconv", "convt1d"
        m = re.match(r"^blocks\.(\d+)\.(convs1|convs2)\.(\d+)\.1(\.conv)?$", key)
        if m:
            tail = "/conv" if m.group(4) else ""
            return (f"blocks_{m.group(1)}/{m.group(2)}_{m.group(3)}{tail}",
                    "conv1d")
        if key == "output_conv.1":
            return "output_conv", "conv1d"
        if key == "output_conv.1.conv":
            return "output_conv/conv", "conv1d"
        return None

    return rule


def _hifigan_period_rule() -> Rule:
    def rule(key):
        m = re.match(r"^convs\.(\d+)\.0$", key)
        if m:
            return f"convs_{m.group(1)}", "conv2d"
        if key == "output_conv":
            return "output_conv", "conv2d"
        return None

    return rule


def _hifigan_scale_rule() -> Rule:
    def rule(key):
        m = re.match(r"^layers\.(\d+)(?:\.0)?$", key)
        if m:
            return f"layer_{m.group(1)}", "conv1d"
        return None

    return rule


def _style_melgan_generator_rule(config) -> Rule:
    def rule(key):
        m = re.match(r"^noise_upsample\.(\d+)$", key)
        if m:
            return f"noise_upsample_{int(m.group(1)) // 2}", "convt1d"
        m = re.match(
            r"^blocks\.(\d+)\.(tade1|tade2)\.(aux_conv|gated_conv)\.0$", key)
        if m:
            return f"blocks_{m.group(1)}/{m.group(2)}/{m.group(3)}", "conv1d"
        m = re.match(r"^blocks\.(\d+)\.(gated_conv1|gated_conv2)$", key)
        if m:
            return f"blocks_{m.group(1)}/{m.group(2)}", "conv1d"
        if key == "output_conv.0":
            return "output_conv", "conv1d"
        return None

    return rule


def _token_embed_rule(config) -> Rule:
    """The token tables of the discrete generators: ``emb``, ``spk_emb``
    (only where ``num_spk_embs`` > 0: the reference builds it whatever the
    config says) and the layer-sum tables ``emb.<i>`` -> ``emb_<i>``."""
    num_spk = config.get("num_spk_embs", 128)

    def rule(key):
        if key == "emb":
            return "emb", "embedding"
        if key == "spk_emb":
            return ("spk_emb", "embedding") if num_spk > 0 else None
        m = re.match(r"^emb\.(\d+)$", key)
        if m:
            return f"emb_{m.group(1)}", "embedding"
        return None

    return rule


def _with_trunk(token: Rule, trunk: Rule) -> Rule:
    """The token tables, then the trunk's keys under ``trunk/``."""
    def rule(key):
        sub = token(key)
        if sub:
            return sub
        sub = trunk(key)
        if sub:
            return f"trunk/{sub[0]}", sub[1]
        return None

    return rule


def _discrete_hifigan_rule(config) -> Rule:
    return _with_trunk(_token_embed_rule(config),
                       _hifigan_generator_rule(config))


def _discrete_duration_rule(config) -> Rule:
    """+ the duration predictor: its Sequential(conv, ReLU, LayerNorm,
    Dropout) blocks (``conv.<i>.0`` and ``.2``) and its ``linear``."""
    base = _discrete_hifigan_rule(config)

    def rule(key):
        m = re.match(r"^duration_predictor\.conv\.(\d+)\.0$", key)
        if m:
            return f"duration_predictor/conv_{m.group(1)}", "conv1d"
        m = re.match(r"^duration_predictor\.conv\.(\d+)\.2$", key)
        if m:
            return f"duration_predictor/norm_{m.group(1)}", "norm"
        if key == "duration_predictor.linear":
            return "duration_predictor/linear", "dense"
        return base(key)

    return rule


def _discrete_f0_rule(config) -> Rule:
    """+ the f0's Linear and the layer-sum logits ``weights``."""
    base = _discrete_hifigan_rule(config)

    def rule(key):
        if key == "f0_embedding":
            return "f0_embedding", "dense"
        if key == "weights":
            return "weights", "param"
        return base(key)

    return rule


def _discrete_style_melgan_rule(config) -> Rule:
    return _with_trunk(_token_embed_rule(config),
                       _style_melgan_generator_rule(config))


def _vqvae_rule(config) -> Rule:
    """VQVAE: the codebook and the speaker table (embeddings), the local
    condition's 1x1 conv, the encoder as a MelGAN discriminator tower and
    the decoder as a MelGAN generator (``decoder_conf``'s layout)."""
    dec_map = _melgan_sequential_map(config.get("decoder_conf", {}) or {})
    enc = _melgan_discriminator_rules()

    def rule(key):
        if key == "codebook.embedding":
            return "codebook", "embedding"
        if key == "local_embed":
            return "local_embed", "conv1d"
        if key == "global_embed":
            return "global_embed", "embedding"
        if key.startswith("encoder."):
            sub = enc(key[len("encoder."):])
            if sub:
                return f"encoder/{sub[0]}", sub[1]
        if key.startswith("decoder."):
            sub = dec_map.get(key[len("decoder."):])
            if sub:
                return f"decoder/{sub[0]}", sub[1]
        return None

    return rule


def _uhifigan_generator_rule(config) -> Rule:
    def rule(key):
        if key == "input_conv.0":
            return "input_conv", "conv1d"
        if key == "hidden_conv":
            return "hidden_conv", "conv1d"
        if key == "output_conv.1":
            return "output_conv", "conv1d"
        m = re.match(r"^downsamples\.(\d+)\.0$", key)
        if m:
            return f"downsamples_{m.group(1)}", "conv1d"
        m = re.match(r"^upsamples\.(\d+)\.1$", key)
        if m:
            return f"upsamples_{m.group(1)}", "convt1d"
        m = re.match(r"^(downsamples_mrf|upsamples_mrf)\.(\d+)\."
                     r"(convs1|convs2)\.(\d+)\.1$", key)
        if m:
            return (f"{m.group(1)}_{m.group(2)}/{m.group(3)}_{m.group(4)}",
                    "conv1d")
        return None

    return rule


def _multi(rule_fn: Rule, list_name: str = "discriminators") -> Rule:
    def rule(key):
        m = re.match(rf"^{list_name}\.(\d+)\.(.*)$", key)
        if m:
            sub = rule_fn(m.group(2))
            if sub is not None:
                return f"{list_name}_{m.group(1)}/{sub[0]}", sub[1]
        return None

    return rule


def _msmpd_rule(config) -> Rule:
    msd = _multi(_hifigan_scale_rule())
    mpd = _multi(_hifigan_period_rule())

    def rule(key):
        for head, sub_rule in (("msd.", msd), ("mpd.", mpd)):
            if key.startswith(head):
                sub = sub_rule(key[len(head):])
                if sub:
                    return f"{head[:-1]}/{sub[0]}", sub[1]
        return None

    return rule


def _rule_for(model_name: str, config: Dict[str, Any]) -> Rule:
    if model_name == "ParallelWaveGANGenerator":
        return _pwg_generator_rule(config)
    if model_name == "ParallelWaveGANDiscriminator":
        return _pwg_discriminator_rule(config)
    if model_name == "ResidualParallelWaveGANDiscriminator":
        return _rpwg_discriminator_rule(config)
    if model_name == "MelGANGenerator":
        mapping = _melgan_sequential_map(config)
        return mapping.get
    if model_name == "MelGANDiscriminator":
        return _melgan_discriminator_rules()
    if model_name == "MelGANMultiScaleDiscriminator":
        return _multi(_melgan_discriminator_rules())
    if model_name == "HiFiGANGenerator":
        return _hifigan_generator_rule(config)
    if model_name == "HiFiGANPeriodDiscriminator":
        return _hifigan_period_rule()
    if model_name == "HiFiGANMultiPeriodDiscriminator":
        return _multi(_hifigan_period_rule())
    if model_name == "HiFiGANScaleDiscriminator":
        return _hifigan_scale_rule()
    if model_name == "HiFiGANMultiScaleDiscriminator":
        return _multi(_hifigan_scale_rule())
    if model_name == "HiFiGANMultiScaleMultiPeriodDiscriminator":
        return _msmpd_rule(config)
    if model_name == "StyleMelGANGenerator":
        return _style_melgan_generator_rule(config)
    if model_name == "StyleMelGANDiscriminator":
        return _multi(_melgan_discriminator_rules())
    if model_name == "VQVAE":
        return _vqvae_rule(config)
    if model_name == "UHiFiGANGenerator":
        return _uhifigan_generator_rule(config)
    if model_name == "DiscreteSymbolHiFiGANGenerator":
        return _discrete_hifigan_rule(config)
    if model_name == "DiscreteSymbolDurationGenerator":
        return _discrete_duration_rule(config)
    if model_name == "DiscreteSymbolF0Generator":
        return _discrete_f0_rule(config)
    if model_name == "DiscreteSymbolStyleMelGANGenerator":
        return _discrete_style_melgan_rule(config)
    raise KeyError(f"no importer rules for {model_name}")


_PERMS = {"conv1d": (2, 1, 0), "convt1d": (2, 0, 1), "conv2d": (2, 3, 1, 0),
          "dense": (1, 0)}


def _convert(kind: str, name: str, w: np.ndarray) -> Tuple[str, np.ndarray]:
    """(torch leaf name, tensor) -> (flax leaf name, converted tensor)."""
    if name == "bias":
        return "bias", w
    if kind == "embedding":
        if name == "weight":  # nn.Embedding's table, as flax's nn.Embed
            return "embedding", w
        raise ValueError(f"unsupported leaf {name} of an embedding")
    if kind == "norm":  # the dim-selectable LayerNorm: weight -> scale
        return ("scale" if name == "weight" else name), w
    if name in ("weight", "weight_orig"):
        return "kernel", w.transpose(_PERMS[kind])
    if name == "weight_v":
        return "kernel_v", w.transpose(_PERMS[kind])
    if name == "weight_g":
        g = w.reshape(w.shape[0])
        if kind == "convt1d":
            # torch's g is per input channel: (I, 1, 1) -> (1, I, 1)
            return "kernel_g", g.reshape(1, g.shape[0], 1)
        return "kernel_g", g.reshape([1] * (w.ndim - 1) + [g.shape[0]])
    raise ValueError(f"unsupported leaf {name} for kind {kind}")


def _set_path(tree: Dict[str, Any], path: str, name: str,
              value: np.ndarray) -> None:
    node = tree
    for part in path.split("/"):
        node = node.setdefault(part, {})
    node[name] = value


def import_model_params(
    state_dict: Dict[str, Any],
    model_name: str,
    config: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """A reference state_dict -> {"params": tree} (plus "spectral": tree of
    the power-iteration vectors u of a spectral-normed discriminator).
    Buffers that are not parameters (PQMF filters, mean/scale stats) are
    skipped."""
    rule = _rule_for(model_name, config or {})
    params: Dict[str, Any] = {}
    spectral: Dict[str, Any] = {}
    skipped: List[str] = []
    for key, tensor in state_dict.items():
        # a copy: torch updates some tensors in place (spectral-norm u)
        w = np.array(tensor.detach().cpu().float().numpy()
                     if hasattr(tensor, "detach") else tensor,
                     dtype=np.float32, copy=True)
        if "." not in key:
            # a bare top-level parameter (the F0 generator's weights)
            direct = rule(key)
            if direct is not None and direct[1] == "param":
                params[direct[0]] = w
                continue
        prefix, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if leaf in ("analysis_filter", "synthesis_filter", "updown_filter",
                    "window", "melmat") or (
                        prefix == "" and leaf in ("mean", "scale")):
            skipped.append(key)
            continue
        mapped = rule(prefix)
        if mapped is None:
            skipped.append(key)
            continue
        path, kind = mapped
        if leaf == "weight_u":
            _set_path(spectral, path, "u", w)
            continue
        if leaf == "weight_v" and f"{prefix}.weight_orig" in state_dict:
            continue  # spectral norm's other power-iteration vector
        name, value = _convert(kind, leaf, w)
        _set_path(params, path, name, value)
    out = {"params": params}
    if spectral:
        out["spectral"] = spectral
    if skipped:
        logging.debug("torch_import skipped keys: %s", skipped)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference ``checkpoint-<N>steps.pkl`` on the CPU. Only
    tensors and plain containers are unpickled (``weights_only``)."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)
