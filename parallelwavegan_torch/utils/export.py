"""Serving export: a generator's synthesis function through ``torch.export``.

Counterpart of ``parallelwavegan_tpu/utils/export.py``, which lowers
``gen.apply(variables, mel)`` (plus PQMF synthesis for a multi-band
generator) to StableHLO at a fixed (batch, frames) shape. Here the same
function, ``InferenceModel``'s plain module forward ``generator(mel)``
followed by PQMF synthesis, is captured by ``torch.export`` at a fixed
(batch, frames, num_mels) float32 input and serialized with
``torch.export.save``; ``load_exported`` returns a callable module.

As in the JAX package the export takes the generator's own forward, never
the serving fast paths: the CUDA kernels of the fused WaveNet stack (B1)
and the fused MRF stage (B3) are ctypes calls, which ``torch.export``
cannot trace, so neither they nor the int8 modes are in the program.

The families are the ones whose forward takes one input, as JAX
``export_generator``'s ``gen.apply(variables, mel)``: MelGAN (multi-band
too), HiFi-GAN and the token HiFi-GAN, whose "mel" is its float id columns
(``num_mels`` of them, read as int64 ids inside the program, never cast to
a lower precision). The others raise a ``ValueError`` that names the
family and why. The JAX function also exports the F0 generator, whose
apply then skips the f0; the port refuses it, since its serving reads the
f0.
"""

from __future__ import annotations

import io
from typing import Optional, Union

import torch
from torch import nn

# generator family -> why its forward does not take the mel alone
NOT_EXPORTABLE = {
    "ParallelWaveGANGenerator": "its forward takes the noise z first and "
                                "the mel second (z, c)",
    "StyleMelGANGenerator": "its forward draws noise z besides the mel",
    "UHiFiGANGenerator": "its forward takes the f0 and the excitation "
                         "besides the mel",
    "VQVAE": "it encodes audio, not a mel",
    "DiscreteSymbolDurationGenerator": "its forward takes token ids and "
                                       "durations",
    "DiscreteSymbolF0Generator": "its forward takes the f0 besides the ids",
    "DiscreteSymbolStyleMelGANGenerator": "its forward draws noise z "
                                          "besides the ids",
}


class _Synthesis(nn.Module):
    """mel (B, frames, num_mels) float32 -> wave (B, samples, 1) in the
    generator's dtype: the generator (on the mel cast to ``dtype``, or as
    it is for None), then PQMF synthesis if multi-band."""

    def __init__(self, generator: nn.Module, pqmf: Optional[nn.Module],
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.generator = generator
        self.pqmf = pqmf
        self.dtype = dtype

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        y = self.generator(mel if self.dtype is None else mel.to(self.dtype))
        if self.pqmf is not None:
            y = self.pqmf.synthesis(y)
        return y


def export_generator(model, batch_size: int = 1, num_frames: int = 512,
                     path: Optional[str] = None) -> bytes:
    """Export ``model``'s (an ``InferenceModel``) synthesis function for a
    fixed (batch_size, num_frames, num_mels) float32 input on the model's
    device. Returns the serialized program (also written to ``path`` if
    given)."""
    if model.gen_type in NOT_EXPORTABLE:
        raise ValueError(
            f"{model.gen_type} cannot be exported: "
            f"{NOT_EXPORTABLE[model.gen_type]}, and the export takes the "
            "mel alone, as the JAX package's export_generator does")
    num_mels = model.config.get("num_mels", 80)
    mel = torch.zeros((batch_size, num_frames, num_mels),
                      dtype=torch.float32, device=model.device)
    # token ids stay float32 (exact below 2^24) up to the module's lookup
    ids = model.gen_type.startswith("DiscreteSymbol")
    module = _Synthesis(model.generator, model.pqmf,
                        None if ids else model.dtype).eval()
    with torch.no_grad():
        if model.pqmf is not None:
            # the PQMF kernel is made once per device and dtype and cached:
            # make it here, so the trace reads it as a constant (made under
            # the trace it would be cached as a traced value)
            model.pqmf.synthesis(torch.zeros(
                (1, 1, model.pqmf.subbands), dtype=model.dtype,
                device=model.device))
        program = torch.export.export(module, (mel,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(blob: Union[bytes, bytearray, str]) -> nn.Module:
    """Deserialize an exported generator (its bytes or a path); returns a
    callable module of the mel, its parameters frozen for serving."""
    source = blob if isinstance(blob, str) else io.BytesIO(bytes(blob))
    return torch.export.load(source).module().requires_grad_(False)
