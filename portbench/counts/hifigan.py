"""HiFi-GAN's operations: the generator's forward."""

from __future__ import annotations

from portbench.core.yardstick import mrf_flops


def generator_flops_per_frame(gp: dict) -> float:
    """The forward per input frame: conv in, each transposed conv (2 Cin
    Cout K per input sample of its stage), each stage's MRF blocks, conv
    out."""
    C, K, cin = gp["channels"], gp["kernel_size"], gp["in_channels"]
    total = 2.0 * K * cin * C
    length = 1
    for i, (s, k_up) in enumerate(zip(gp["upsample_scales"],
                                      gp["upsample_kernel_sizes"])):
        c_in, c_out = C // 2 ** i, C // 2 ** (i + 1)
        total += 2.0 * c_in * c_out * k_up * length
        length *= s
        total += mrf_flops(length, c_out, gp["resblock_kernel_sizes"],
                           len(gp["resblock_dilations"][0]))
    c_last = C // 2 ** len(gp["upsample_scales"])
    return total + 2.0 * K * c_last * gp["out_channels"] * length


def forward_flops(config: dict, samples: int) -> float:
    return generator_flops_per_frame(config["generator_params"]) \
        * samples / config["hop_size"]
