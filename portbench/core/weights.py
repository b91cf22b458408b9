"""Weights made from the seed, or read from a checkpoint, as the
configuration file's ``portbench.weights`` says.

Seeded weights are drawn on the device in one call from a
``torch.Generator`` seeded by the run's seed and cut into the leaves of
the tree the reference names (the checkpoint layout, weight norm as v and
g). v ~ N(0, 1) and g = 1, so each folded kernel has unit-norm output
columns: per-entry 1 / sqrt(K Cin), which brings the waveform to a full
scale level (at a module's own init it sits orders of magnitude lower,
where no tolerance tells right from wrong). A smoothing conv of the
upsampler stays near its mean-filter init (v = 1 + 0.1 N(0, 1), g the
mean filter's norm); biases are 0.1 N(0, 1).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch

from portbench.core.manifest import plugin
from portbench.reference.gckpt import flatten, read_gckpt

Tree = Dict[str, torch.Tensor]


def reference_module(config: dict):
    return plugin(config, "reference")


def seeded(shapes: Dict[str, Tuple], seed: int, device: str) -> Tree:
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    out: Tree = {}
    at = 0
    for name in sorted(shapes):
        shape = shapes[name]
        n = math.prod(shape)
        t = flat[at:at + n].reshape(shape)
        at += n
        if ".upsample.conv_" in name and name.endswith("kernel_v"):
            t = 1.0 + 0.1 * t
        elif ".upsample.conv_" in name and name.endswith("kernel_g"):
            taps = shapes[name[:-1] + "v"][1]
            t = torch.full(shape, 1.0 / math.sqrt(taps), device=device)
        elif name.endswith("kernel_g"):
            t = torch.ones(shape, device=device)
        elif name.endswith("bias"):
            t = 0.1 * t
        out[name] = t.contiguous()
    return out


def generator_tree(root: str, config: dict, seed: int, device: str) -> Tree:
    """The generator's weights as the reference reads them: a flat tree in
    the checkpoint layout, in the dtype stored."""
    spec = config["portbench"]["weights"]
    if spec["source"] == "gckpt":
        tree = flatten(read_gckpt(os.path.join(root, spec["path"])))
        return {k[len("params."):]: v for k, v in tree.items()}
    if spec["source"] == "seeded":
        shapes = reference_module(config).generator_shapes(
            config["generator_params"], weight_norm=True)
        return seeded(shapes, seed, device)
    raise ValueError(f"unknown weight source {spec['source']!r}")


def folded(tree: Tree, ref) -> Tree:
    """Weight norm applied in the dtype stored (as the format defines a
    checkpoint's kernels), then every leaf in float32."""
    out: Tree = {}
    for name, t in tree.items():
        if name.endswith(".kernel_v"):
            out[name[:-2]] = ref.kernel(tree, name[:-len(".kernel_v")]).float()
        elif not name.endswith(".kernel_g"):
            out[name] = t.float()
    return out


def nested(tree: Tree) -> dict:
    out: dict = {}
    for name, t in tree.items():
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out
