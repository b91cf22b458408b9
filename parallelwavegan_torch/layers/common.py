"""Core modules: the channels-last Conv1d, ConvTranspose1d and Conv2d,
the token table ``Embed``, the ``Dense`` layer and the channel
``ChannelLayerNorm``, initializers, activations, instance norm.

Counterpart of ``parallelwavegan_tpu/layers/common.py``. Kernels keep the
JAX package's (K..., Cin, Cout) layout. Initializers draw from an explicit
``torch.Generator`` and follow the JAX package's distributions: PWG convs
kaiming-normal (relu) with zero bias, the upsample smoothing conv a mean
filter, HiFi-GAN generator convs N(0, 0.01) with torch's uniform bias, the
HiFi-GAN discriminators torch's default U(+-1/sqrt(fan_in)) for both. A
conv holds either the *folded* kernel (weight norm already
applied, see ``utils/params.py``; the serving form) or, with
``use_weight_norm``, the parameters ``kernel_v`` and ``kernel_g`` that the
JAX package trains (``parallelwavegan_tpu/layers/common.py:129-147``): the
kernel is then folded in every forward, so gradients reach v and g. At
initialisation weight norm sets g = ||v||, so either form starts from the
initializer's sample.

``use_spectral_norm`` divides the kernel by its largest singular value,
estimated by one power iteration a forward from the buffer ``u`` (flax:
the ``spectral`` collection), written by hand as the JAX package does it
(``layers/common.py:154-172``): ``u`` advances only in training mode and the
kernel is divided by a *constant* sigma (no gradient flows through sigma,
unlike ``torch.nn.utils.spectral_norm``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.ops import conv as conv_ops
from parallelwavegan_torch.ops.conv import PadLike
from parallelwavegan_torch.utils.params import fold_weight_norm

Initializer = Callable[..., torch.Tensor]


def _fan_in(shape: Sequence[int]) -> int:
    return math.prod(shape[:-1])


def torch_conv_default_init(shape, generator=None, dtype=torch.float32):
    """torch's default conv kernel init: U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fan_in(shape))
    return (torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1) * bound


def kaiming_normal_relu_init(shape, generator=None, dtype=torch.float32):
    """torch.nn.init.kaiming_normal_(nonlinearity='relu'): N(0, 2/fan_in)."""
    std = math.sqrt(2.0 / _fan_in(shape))
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def zeros_init(shape, generator=None, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def mean_filter_init(shape, generator=None, dtype=torch.float32):
    """Smoothing-conv init to a mean filter over all but the last two axes."""
    return torch.full(shape, 1.0 / math.prod(shape[:-2]), dtype=dtype)


def normal_init(std: float) -> Initializer:
    """N(0, std^2): HiFi-GAN's kernel init with std 0.01."""
    def init(shape, generator=None, dtype=torch.float32):
        return std * torch.randn(shape, generator=generator, dtype=dtype)

    return init


def uniform_bias_init_for(kernel_shape: Sequence[int]) -> Initializer:
    """torch's default conv bias init: U(+-1/sqrt(fan_in of the kernel))."""
    bound = 1.0 / math.sqrt(_fan_in(kernel_shape))

    def init(shape, generator=None, dtype=torch.float32):
        return (torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1) \
            * bound

    return init


def spectral_normalize(kernel: torch.Tensor, u: torch.Tensor,
                       update: bool) -> torch.Tensor:
    """kernel / sigma with sigma from one power iteration started at ``u``
    (O,), in the kernel's dtype; ``update`` stores the new u in place.
    sigma and u carry no gradient."""
    with torch.no_grad():
        w = kernel.reshape(-1, kernel.shape[-1]).t()  # (O, N)
        v = w.t() @ u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
        u_new = w @ v
        u_new = u_new / torch.clamp(torch.linalg.vector_norm(u_new), min=1e-12)
        sigma = u_new @ (w @ v)
        if update:
            u.copy_(u_new)
    return kernel / sigma


def get_activation(name: Optional[str], params: Optional[dict] = None):
    """Map a torch.nn activation class name (as configs spell it) to a
    function, as the JAX package's registry does: None, LeakyReLU, ReLU,
    ELU(alpha), GELU (flax's ``nn.gelu``, the tanh approximation, where
    torch's default is the exact erf form), Tanh, Sigmoid, Softmax (over the
    last axis: the channels of the (B, T, C) layout, torch's dim 1) and
    SiLU / Swish."""
    params = dict(params or {})
    if name is None:
        return lambda x: x
    if name == "LeakyReLU":
        return partial(F.leaky_relu,
                       negative_slope=params.get("negative_slope", 0.01))
    if name == "ReLU":
        return F.relu
    if name == "ELU":
        return partial(F.elu, alpha=params.get("alpha", 1.0))
    if name == "GELU":
        return partial(F.gelu, approximate="tanh")
    if name == "Tanh":
        return torch.tanh
    if name == "Sigmoid":
        return torch.sigmoid
    if name == "Softmax":
        return partial(torch.softmax, dim=-1)
    if name in ("SiLU", "Swish"):
        return F.silu
    raise ValueError(f"unsupported activation: {name}")


def apply_dropout_mask(x: torch.Tensor, mask: torch.Tensor,
                       rate: float) -> torch.Tensor:
    """flax's ``nn.Dropout`` on a given keep mask (bool, x's shape): a kept
    entry is x / keep, with keep = 1 - rate rounded to x's dtype as flax
    divides by a weakly typed scalar; a dropped one is 0."""
    mask = mask.to(x.device)
    if mask.shape != x.shape:
        raise ValueError(f"dropout mask {tuple(mask.shape)} for an input of "
                         f"{tuple(x.shape)}")
    keep = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def draw_keep_masks(shapes: Sequence[Tuple[int, ...]], rate: float,
                    generator: Optional[torch.Generator]) -> list:
    """Keep masks (bool, on ``generator``'s device) of the given shapes, in
    order: uniform < 1 - rate. An empty list when the rate is 0."""
    if rate == 0.0:
        return []
    device = generator.device if generator is not None else None
    return [torch.rand(shape, generator=generator, device=device) < 1.0 - rate
            for shape in shapes]


# torch pad-module name (as configs spell it) -> pad1d mode
_PAD_MODES = {
    "ConstantPad1d": "zeros",
    "ZeroPad1d": "zeros",
    "ReflectionPad1d": "reflect",
    "ReplicationPad1d": "replicate",
}


def pad_mode_from_torch(name: str) -> str:
    """The ``pad1d`` mode of a torch pad-module name."""
    if name in _PAD_MODES:
        return _PAD_MODES[name]
    raise ValueError(f"unsupported pad module: {name}")


def instance_norm_1d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch's InstanceNorm1d without affine: (B, T, C) normalised over T
    with the biased variance. The statistics of a bf16 input are taken in
    f32 and the result rounded once, as the JAX package's ``jnp.mean``
    accumulates bf16 in f32."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = xf.mean(dim=1, keepdim=True)
    var = xf.var(dim=1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class WeightNormedConv(nn.Module):
    """Kernel handling shared by the convs: one ``kernel`` parameter, or
    ``kernel_v`` and ``kernel_g``. g has size 1 on ``wn_axes``, the axes
    the norm is taken over: by default every axis but the last (g of shape
    (1, ..., 1, Cout), per output channel); a transposed conv passes (0, 2)
    (g of shape (1, Cin, 1), per input channel). With
    ``use_spectral_norm`` the kernel is one parameter and the buffer ``u``
    (Cout,) starts at N(0, 1) / sqrt(Cout)."""

    def init_kernel(self, shape, kernel_init: Initializer,
                    use_weight_norm: bool, generator,
                    wn_axes: Optional[Sequence[int]] = None,
                    use_spectral_norm: bool = False) -> None:
        if use_weight_norm and use_spectral_norm:
            raise ValueError("Either use use_weight_norm or use_spectral_norm.")
        kernel = kernel_init(shape, generator)
        if use_spectral_norm:
            self.register_buffer(
                "u", torch.randn((shape[-1],), generator=generator)
                / math.sqrt(shape[-1]))
        if use_weight_norm:
            axes = (tuple(range(kernel.dim() - 1)) if wn_axes is None
                    else tuple(wn_axes))
            self.kernel_v = nn.Parameter(kernel)
            self.kernel_g = nn.Parameter(
                torch.sqrt(torch.sum(kernel * kernel, dim=axes, keepdim=True))
            )
        else:
            self.kernel = nn.Parameter(kernel)

    def folded_kernel(self) -> torch.Tensor:
        """The kernel the conv applies, differentiable in v and g (or in
        the spectral-normed kernel); in training mode a spectral-normed
        conv advances ``u``."""
        if "kernel" not in self._parameters:
            return fold_weight_norm(self.kernel_v, self.kernel_g)
        if "u" in self._buffers:
            return spectral_normalize(self.kernel, self.u, self.training)
        return self.kernel


class Conv1d(WeightNormedConv):
    """Conv1d on (B, T, Cin) -> (B, T', Cout) with zero padding. The
    default inits are PWG's; ``bias_init=None`` is torch's uniform bias
    for the kernel's fan-in (the JAX module's default)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 1,
        dilation: int = 1,
        bias: bool = True,
        padding: PadLike = 0,
        kernel_init: Initializer = kaiming_normal_relu_init,
        bias_init: Optional[Initializer] = zeros_init,
        use_weight_norm: bool = False,
        stride: int = 1,
        groups: int = 1,
        use_spectral_norm: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dilation, self.padding = dilation, padding
        self.stride, self.groups = stride, groups
        shape = (kernel_size, in_channels // groups, features)
        self.init_kernel(shape, kernel_init, use_weight_norm, generator,
                         use_spectral_norm=use_spectral_norm)
        if bias:
            init = bias_init or uniform_bias_init_for(shape)
            self.bias = nn.Parameter(init((features,), generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv1d(x, self.folded_kernel(), self.bias,
                               self.padding, self.dilation, self.stride,
                               self.groups)


class Conv2d(WeightNormedConv):
    """Conv2d on (B, H, W, Cin) -> (B, H', W', Cout), kernel
    (KH, KW, Cin, Cout), zero padding (rows, columns) on both sides; the
    default inits are torch's uniform ones, as the JAX module's."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Tuple[int, int] = (1, 1),
        stride: Tuple[int, int] = (1, 1),
        padding: Tuple[int, int] = (0, 0),
        bias: bool = True,
        kernel_init: Initializer = torch_conv_default_init,
        bias_init: Optional[Initializer] = None,
        use_weight_norm: bool = False,
        use_spectral_norm: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        shape = (*kernel_size, in_channels, features)
        self.init_kernel(shape, kernel_init, use_weight_norm, generator,
                         use_spectral_norm=use_spectral_norm)
        if bias:
            init = bias_init or uniform_bias_init_for(shape)
            self.bias = nn.Parameter(init((features,), generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv2d(x, self.folded_kernel(), self.bias,
                               self.stride, self.padding)


class ConvTranspose1d(WeightNormedConv):
    """Transposed Conv1d on (B, T, Cin) -> (B, T', Cout) with torch's
    ConvTranspose1d length semantics. The kernel is (K, Cin, Cout); weight
    norm is per input channel (g of shape (1, Cin, 1)), as torch's
    ``weight_norm`` (dim 0) sees a transposed conv's (Cin, Cout, K) weight.
    The default bias init is torch's, whose fan-in for a transposed conv is
    K * Cout."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        output_padding: int = 0,
        bias: bool = True,
        kernel_init: Initializer = kaiming_normal_relu_init,
        bias_init: Optional[Initializer] = None,
        use_weight_norm: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.init_kernel((kernel_size, in_channels, features), kernel_init,
                         use_weight_norm, generator, wn_axes=(0, 2))
        if bias:
            init = bias_init or uniform_bias_init_for(
                (kernel_size, features, in_channels))
            self.bias = nn.Parameter(init((features,), generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv_transpose1d(
            x, self.folded_kernel(), self.bias, self.stride, self.padding,
            self.output_padding)


class Embed(nn.Module):
    """flax's ``nn.Embed``: the table ``embedding`` (N, D), N(0, 1) at
    init, looked up by integer ids (``models.discrete.check_ids`` checks
    them on the host)."""

    def __init__(self, num_embeddings: int, features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn((num_embeddings, features), generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding)


class Dense(nn.Module):
    """The JAX package's ``Dense``: y = x @ kernel + bias over the last
    axis, ``kernel`` (in, out) at torch's U(+-1/sqrt(in)), the bias
    likewise."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (in_features, features)
        self.kernel = nn.Parameter(torch_conv_default_init(shape, generator))
        if bias:
            self.bias = nn.Parameter(
                uniform_bias_init_for(shape)((features,), generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, T, C) with ``scale`` (ones)
    and ``bias`` (zeros), eps 1e-12, the reference's dim-selectable
    LayerNorm. The statistics of a bf16 input are taken in f32 and rounded
    to bf16, as ``jnp.mean`` and ``jnp.var`` take them; the rest runs in
    the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias
