"""Parallel WaveGAN's operations: the generator's forward and the (G,
adv, D) training step."""

from __future__ import annotations


def generator_flops_per_sample(gp: dict, hop: int) -> float:
    """The forward per output sample: the WaveNet layers, first and last
    1x1s, and per sample its share of the upsampling (the context conv per
    frame, each (1, 2s + 1) smoothing conv per sample of its output)."""
    R, G, S = gp["residual_channels"], gp["gate_channels"], gp["skip_channels"]
    A, K, L = gp["aux_channels"], gp["kernel_size"], gp["layers"]
    per_layer = K * R * G + A * G + (G // 2) * (S + R)
    stack = 2.0 * L * per_layer
    ends = 2.0 * (gp["in_channels"] * R + S * S + S * gp["out_channels"])
    ctx = gp["aux_context_window"]
    conv_in = 2.0 * (2 * ctx + 1) * A * A / hop
    scales = gp["upsample_params"]["upsample_scales"]
    smooth, length = 0.0, 1.0
    for s in scales:
        length *= s
        smooth += 2.0 * (2 * s + 1) * A * length / hop
    return stack + ends + conv_in + smooth


def discriminator_flops_per_sample(dp: dict) -> float:
    K, C, L = dp["kernel_size"], dp["conv_channels"], dp["layers"]
    cin, cout = dp["in_channels"], dp["out_channels"]
    return 2.0 * K * (cin * C + (L - 2) * C * C + C * cout)


def forward_flops(config: dict, samples: int) -> float:
    return generator_flops_per_sample(config["generator_params"],
                                      config["hop_size"]) * samples


def train_step_flops(config: dict, batch: int, samples: int) -> float:
    """One (G, adv, D) step, a backward counted as twice its forward: G
    forward and backward (3 forwards), G's forward again for the
    discriminator update (1); D on the fake batch and the input gradient
    back through it (2); D on real and fake and its backward (6). The STFT
    losses are left out (FFTs, under 1 %)."""
    rows = batch * samples
    d = discriminator_flops_per_sample(config["discriminator_params"])
    return 4.0 * forward_flops(config, rows) + 8.0 * d * rows
