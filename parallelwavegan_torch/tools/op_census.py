"""Every distinct card op of the training steps, held to float64.

One f32 (G, adv, D) step of each recipe runs under ``Census``, a
``TorchDispatchMode`` that records each distinct aten call the step makes,
forward and backward alike. A call's key is its op, its arguments, and the
shape, strides and dtype of each of its tensors. Elementwise arithmetic,
comparisons, copies, views, factories, random draws and host reads are left
out by name (``LEFT_OUT``); every other op is checked.

Each distinct key is replayed (``replay``) on three routes: the card in f32
(k), the CPU in f32 (p) and the CPU in float64 (e). Integer and boolean
tensors (ids, indices, masks) come from the recording by value; float
tensors are seeded draws of the recorded shape and strides, slices of one
seeded pool (``draw_pool``), the same values on every route. A backward op
is replayed as the aten backward op itself, with its recorded arguments;
autograd is not involved. Where the CPU's float64 kernel refuses a layout,
that route alone takes contiguous copies (``slow_conv2d`` refuses some
weight layouts, ``ops/conv.conv2d``).

Sizes (``cut_candidates``): only a tensor derived from the step's batch
or its random draws, and not shaped like one of the recipe's parameters
(``Census`` tracks both), is cut: its batch axis (a leading axis of the
recipe's batch or twice it, real and fake together) to ``CUT_BATCH``, and
each of its time axes to the larger of ``MIN_FRAMES`` and ``RF_MULTIPLE``
receptive fields. A time axis is one longer than ``MIN_FRAMES`` (no channel
count of these recipes is) whose length no tensor of the call that is not
derived from the batch has (the STFT basis's 2,050 columns stay where the
product's cotangent meets them). Channels, kernel, stride, groups, dilation,
padding, parameters, constants and the order of the strides (the layout)
stay. Float64 on the CPU at a recipe's batch would take minutes.

The card also runs each cut key once at its recorded shape, on the same
seeded draws. Where an output depends on the first batch element alone, that
element is held to float64 by the rule below: a convolution's output and
input gradient against the cut's CPU routes, the first element's inputs
there being the cut's (zero-extended along a cut time axis, which a
zero-padded convolution cannot tell from the cut's own padding; the
convolutions take most of the census's CPU time, and this adds none); every
other such output (pads and their backward, normalizations, reductions
along time, cumsum, gather, softmax) against the CPU routes of the key with
the batch cut to that element alone at its recorded length
(``element0_args``). That checks a card algorithm picked only at the
recipe's batch. Every output of the full-shape run must be finite.

Rule (``check_outputs``), per key and float output, that of
``tests/test_torch_cuda.py::test_avg_pool1d_gradient_on_card_matches_float64``:
max |k - e| / (1 + max |e|) <= ``FACTOR`` x the same of p + ``FLOOR``. A
key past it shows rounding excess; a key whose k lies past ``WRONG`` (1e-4
of 1 + max, the f32 correctness limit) gives a wrong result, within the
rule or not. An integer output (argmin, searchsorted) of k may differ from
e's at no more places than p's does.

``chip_smoke.py`` step 19 runs the census on its recipes and its process
pool (``op_census_on_card.py`` beside it runs that step alone); ``report``
prints one line per op kind and raises on a wrong key.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

FACTOR, FLOOR, WRONG = 2.0, 1e-6, 1e-4
CUT_BATCH, MIN_FRAMES, RF_MULTIPLE = 2, 2048, 4
POOL_SIZE = 1 << 24  # float32 draws shared by every key (64 MB)

# elementwise arithmetic and comparisons (and the optimizers' foreach forms)
POINTWISE = frozenset("""
    abs add addcdiv addcmul bitwise_and bitwise_not bitwise_or ceil clamp
    clamp_max clamp_min cos div elu elu_backward eq erf exp expm1 floor
    fmod ge gelu gelu_backward gt hardtanh hardtanh_backward isinf isnan le
    leaky_relu leaky_relu_backward lerp log log1p log2 logical_and
    logical_not logical_or lt masked_fill maximum minimum mul ne neg pow
    reciprocal relu remainder round rsqrt sgn sigmoid sigmoid_backward sign
    silu silu_backward sin softplus softplus_backward sqrt square sub tanh
    tanh_backward threshold threshold_backward trunc where xlogy
    abs_ add_ addcdiv_ addcmul_ clamp_ clamp_min_ div_ fill_ lerp_
    masked_fill_ mul_ neg_ pow_ sqrt_ sub_ zero_
    _foreach_abs _foreach_add _foreach_add_ _foreach_addcdiv
    _foreach_addcdiv_ _foreach_addcmul _foreach_addcmul_ _foreach_clamp_max_
    _foreach_clamp_min_ _foreach_copy_ _foreach_div _foreach_div_
    _foreach_lerp_ _foreach_maximum_ _foreach_mul _foreach_mul_ _foreach_neg
    _foreach_neg_ _foreach_reciprocal _foreach_sign _foreach_sqrt
    _foreach_sqrt_ _foreach_sub _foreach_sub_ _foreach_zero_
""".split())
# copies and views: no arithmetic (the pads and cat stay checked)
COPIES = frozenset("""
    _to_copy clone contiguous copy copy_ detach alias as_strided expand
    permute reshape select slice squeeze t transpose unfold unsqueeze view
    _unsafe_view view_as_complex view_as_real _reshape_alias lift_fresh
    lift_fresh_copy select_backward slice_backward expand_as split
    split_with_sizes unbind narrow _conj _neg_view resolve_conj resolve_neg
""".split())
FACTORIES = frozenset("""
    arange empty empty_like empty_strided eye full full_like linspace
    new_empty new_empty_strided new_full new_ones new_zeros ones ones_like
    scalar_tensor zeros zeros_like
""".split())
RANDOM = frozenset("""
    bernoulli bernoulli_ multinomial native_dropout normal normal_ rand
    rand_like randint randint_like randn randn_like randperm uniform_
""".split())
HOST = frozenset("_local_scalar_dense item is_nonzero".split())
LEFT_OUT = POINTWISE | COPIES | FACTORIES | RANDOM | HOST


@dataclasses.dataclass
class TensorSpec:
    """A recorded tensor: shape, strides, dtype; integer and boolean
    tensors keep their values (leading blocks of them after a cut).
    ``data``: derived from the step's batch or its random draws and not
    shaped like a parameter, so that its batch and time axes may be cut.
    ``of``: the recorded tensor whose first batch element this is
    (``element0_args``), drawn as that tensor's first element."""
    shape: tuple
    stride: tuple
    dtype: torch.dtype
    values: Optional[np.ndarray] = None
    data: bool = False
    of: Optional["TensorSpec"] = None


class _Device:
    """A recorded device argument: the route's device on replay."""

    def __repr__(self) -> str:
        return "device"


DEVICE = _Device()


def _spec(x, keep_values: bool, data=lambda t: False):
    if isinstance(x, torch.Tensor):
        values = None
        if not (x.dtype.is_floating_point or x.dtype.is_complex) \
                and keep_values:
            values = x.detach().cpu().contiguous().numpy()
        return TensorSpec(tuple(x.shape), tuple(x.stride()), x.dtype, values,
                          data(x))
    if isinstance(x, (list, tuple)):
        return type(x)(_spec(v, keep_values, data) for v in x)
    if isinstance(x, dict):
        return {k: _spec(v, keep_values, data) for k, v in x.items()}
    if isinstance(x, torch.device):
        return DEVICE
    return x


def _signature(x):
    if isinstance(x, TensorSpec):
        return ("T", x.shape, x.stride, str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, torch.dtype):
        return str(x)
    return repr(x)


@dataclasses.dataclass
class Record:
    """One distinct key: the op (``aten.<name>.<overload>``), its arguments
    as specs, the recipe that first made it and its batch sizes, and how
    often the recorded steps called it."""
    op: str
    args: tuple
    kwargs: dict
    recipe: str
    batch: tuple
    calls: int = 1

    @property
    def name(self) -> str:
        return self.op.split(".")[1]


def op_name(func) -> str:
    return f"aten.{func.overloadpacket.__name__}.{func._overloadname}"


def resolve(op: str):
    _, packet, overload = op.split(".")
    return getattr(getattr(torch.ops.aten, packet), overload)


class Census(TorchDispatchMode):
    """Records the distinct checked keys of what runs under it
    (``records``, in order of first call), tagged with the recipe that
    ``start`` names and the batch sizes the cut takes for a batch axis.
    Every tensor that an op makes from a tensor derived from the batch, or
    that a random draw makes, is derived from the batch (``derived``); its
    spec is ``data`` unless a parameter of the recipe has its shape (a
    gradient, an optimizer's state)."""

    def __init__(self):
        super().__init__()
        self.records: Dict[tuple, Record] = {}
        self.recipe, self.batch = "", ()
        self.derived = WeakIdKeyDictionary()
        self.static_shapes: frozenset = frozenset()

    def start(self, recipe: str, batch: tuple, inputs, static_shapes
              ) -> None:
        """The next recipe's name, the batch sizes of its batch axes, its
        step's input tensors and its parameters' shapes."""
        self.recipe, self.batch = recipe, batch
        self.static_shapes = frozenset(tuple(s) for s in static_shapes)
        for t in inputs:
            self.derived[t] = True

    def _data(self, t: torch.Tensor) -> bool:
        return t in self.derived and tuple(t.shape) not in self.static_shapes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in RANDOM or any(
                isinstance(t, torch.Tensor) and t in self.derived
                for t in tree_leaves((args, kwargs))):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.derived[t] = True
        if name not in LEFT_OUT:
            op = op_name(func)
            sargs, skw = _spec(args, False), _spec(kwargs, False)
            key = (op, _signature(sargs), _signature(skw))
            rec = self.records.get(key)
            if rec is None:
                self.records[key] = Record(
                    op, _spec(args, True, self._data),
                    _spec(kwargs, True, self._data), self.recipe, self.batch)
            else:
                rec.calls += 1
        return out


def op_kind(rec: Record) -> str:
    """The table's row: the op, a convolution with its form."""
    if rec.name not in ("convolution", "convolution_backward"):
        return rec.name
    a = rec.args if rec.name == "convolution" else rec.args[1:]
    x, stride, transposed, groups = a[0], a[3], a[6], a[8]
    tags = [f"{len(x.shape) - 2}d"]
    if transposed:
        tags.append("transposed")
    if groups > 1:
        tags.append("grouped")
    if any(s > 1 for s in stride) and not transposed:
        tags.append("strided")
    return f"{rec.name} ({', '.join(tags)})"


# --- cuts -----------------------------------------------------------------

def dense_strides(shape: Sequence[int], like: Sequence[int]) -> tuple:
    """Dense strides for ``shape`` with the dims in the order of ``like``'s
    strides (the layout); dims of stride 0 (expanded) stay 0."""
    order = sorted(range(len(shape)), key=lambda d: (like[d], d))
    stride, step = [0] * len(shape), 1
    for d in order:
        if like[d] == 0 and shape[d] > 1:
            continue
        stride[d] = step
        step *= max(shape[d], 1)
    return tuple(stride)


def recut(t: TensorSpec, shape: Sequence[int]) -> TensorSpec:
    shape = tuple(int(s) for s in shape)
    if shape == t.shape:
        return t
    values = None if t.values is None else np.ascontiguousarray(
        t.values[tuple(slice(0, s) for s in shape)])
    return TensorSpec(shape, dense_strides(shape, t.stride), t.dtype, values,
                      t.data)


def _time_cut(size: int, rf: int = 1) -> int:
    return min(size, max(MIN_FRAMES, RF_MULTIPLE * rf))


def _batch_cut(size: int, batch: Sequence[int]) -> int:
    return CUT_BATCH if size in batch and size > CUT_BATCH else size


def _meta(x):
    if isinstance(x, TensorSpec):
        return torch.empty_strided(x.shape, x.stride, dtype=x.dtype,
                                   device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_meta(v) for v in x)
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, _Device):
        return torch.device("meta")
    return x


def _meta_out(op: str, args, kwargs):
    return resolve(op)(*_meta(args), **_meta(kwargs))


def _conv_input_shape(x: TensorSpec, w: TensorSpec, stride, dilation,
                      transposed, batch) -> list:
    shape = list(x.shape)
    shape[0] = _batch_cut(shape[0], batch)
    for i in range(2, len(shape)):
        rf = dilation[i - 2] * (w.shape[i] - 1) + 1
        if transposed:
            rf = -(-rf // stride[i - 2])
        shape[i] = _time_cut(shape[i], rf)
    return shape


def _cut_generic(args, kwargs, batch, cut_time=True):
    """The batch axis and the time axes of each ``data`` tensor cut, as
    the module docstring says; every other tensor whole."""
    kept = {s for t in _tensors((args, kwargs)) if not t.data
            for s in t.shape}

    def walk(x):
        if isinstance(x, TensorSpec):
            if not x.data:
                return x
            shape = []
            for d, s in enumerate(x.shape):
                if d == 0 and s in batch:
                    s = _batch_cut(s, batch)
                elif cut_time and s > MIN_FRAMES and s not in kept:
                    s = _time_cut(s)
                shape.append(s)
            return recut(x, shape)
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x
    return walk(args), walk(kwargs)


# the indexed axis of these keeps its length: the recorded indices point
# into it
_INDEXING = frozenset("""gather scatter scatter_add index_select index_add
    index index_put _index_put_impl take embedding searchsorted""".split())


def cut_candidates(rec: Record) -> list:
    """[(args, kwargs), ...]: the key's arguments cut as the module
    docstring says, most cut first, ending with the batch alone and the
    recorded arguments; a cut the meta device refuses is dropped. The
    first that the card runs is the key's cut (``run_census``)."""
    a, kw, name, batch = rec.args, rec.kwargs, rec.name, rec.batch
    tries = []
    if name == "convolution":
        x, w = a[0], a[1]
        tries.append(((recut(x, _conv_input_shape(x, w, a[3], a[5], a[6],
                                                   batch)),) + a[1:], kw))
    elif name == "convolution_backward":
        g, x, w = a[0], a[1], a[2]
        xc = recut(x, _conv_input_shape(x, w, a[4], a[6], a[7], batch))
        try:
            out = _meta_out("aten.convolution.default", (
                xc, w, None) + tuple(a[4:10]), {})
            tries.append(((recut(g, out.shape), xc) + a[2:], kw))
        except RuntimeError:
            pass
    elif name == "reflection_pad1d_backward":
        x = a[1]
        xc = _cut_generic((x,), {}, batch)[0][0]
        out = _meta_out("aten.reflection_pad1d.default", (xc, a[2]), {})
        tries.append(((recut(a[0], out.shape), xc) + a[2:], kw))
    elif name == "unfold_backward":
        g, sizes, dim, size, step = a[:5]
        cut = [_batch_cut(s, batch) if d == 0 else s
               for d, s in enumerate(sizes)]
        cut[dim] = _time_cut(sizes[dim], size)
        windows = (cut[dim] - size) // step + 1
        gshape = list(g.shape)
        gshape[:len(cut)] = cut
        gshape[dim] = windows
        tries.append(((recut(g, gshape), cut) + tuple(a[2:]), kw))
    if name not in _INDEXING:
        tries.append(_cut_generic(a, kw, batch))
    tries.append(_cut_generic(a, kw, batch, cut_time=False))
    out = []
    for args, kwargs in tries:
        try:
            _meta_out(rec.op, args, kwargs)
        except NotImplementedError:
            pass
        except (RuntimeError, IndexError, ValueError, TypeError):
            continue
        if all(_signature(args) != _signature(o[0]) for o in out):
            out.append((args, kwargs))
    return out + [(a, kw)]


# --- replay ---------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def draw_pool(device: str = "cpu") -> torch.Tensor:
    """POOL_SIZE standard normal float32 draws from seed 0, made on the
    CPU (the same on every route and process), on ``device``."""
    pool = torch.randn(POOL_SIZE, generator=torch.Generator().manual_seed(0))
    return pool.to(device)


def storage_size(shape, stride) -> int:
    if any(s == 0 for s in shape):
        return 0
    return 1 + sum((s - 1) * st for s, st in zip(shape, stride))


def _route_dtype(dtype: torch.dtype, wide: bool) -> torch.dtype:
    if not wide:
        return dtype
    return {torch.float32: torch.float64,
            torch.complex64: torch.complex128}.get(dtype, dtype)


def _from_pool(pool: torch.Tensor, n: int, offset: int) -> torch.Tensor:
    offset %= POOL_SIZE
    if offset + n <= POOL_SIZE:
        return pool[offset:offset + n]
    reps = -(-(offset + n) // POOL_SIZE)
    return pool.repeat(reps)[offset:offset + n]


def build_args(spec, device, wide: bool, seed: int, contiguous: bool = False):
    """The tensors of ``spec`` on ``device``: floats drawn from the pool at
    offsets from ``seed`` in f32, or float64 where ``wide`` (a spec with
    ``of`` takes the first batch element of that tensor's draw); integers
    and booleans from their values. Strides are the spec's unless
    ``contiguous``."""
    pool = draw_pool(str(device))
    counter = iter(range(1 << 30))

    def walk(x):
        if isinstance(x, TensorSpec):
            i = next(counter)
            if x.values is not None:
                t = torch.from_numpy(x.values).to(device)
                if contiguous or storage_size(x.shape, x.stride) != t.numel():
                    return t
                return torch.empty_strided(x.shape, x.stride, dtype=t.dtype,
                                           device=device).copy_(t)
            dtype = _route_dtype(x.dtype, wide)
            drawn = x.of or x
            n = storage_size(drawn.shape, drawn.stride)
            if x.dtype.is_complex:
                n *= 2
            flat = _from_pool(pool, n, seed * 7919 + i * 1000003)
            if x.dtype.is_complex:
                flat = torch.view_as_complex(flat.reshape(-1, 2).clone())
            if x.of is not None:  # an expanded axis is written once
                src = flat.as_strided(drawn.shape, drawn.stride)[:1]
                buf = torch.empty(storage_size(x.shape, x.stride),
                                  dtype=dtype, device=device)
                dst = buf.as_strided(x.shape, x.stride)
                for d, st in enumerate(x.stride):
                    if st == 0:
                        src, dst = src.narrow(d, 0, 1), dst.narrow(d, 0, 1)
                dst.copy_(src)
                t = buf.as_strided(x.shape, x.stride)
            else:
                t = flat.to(dtype, copy=True).as_strided(x.shape, x.stride)
            return t.contiguous() if contiguous else t
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, _Device):
            return torch.device(device)
        if isinstance(x, torch.dtype):
            return _route_dtype(x, wide)
        return x
    return walk(spec)


def flat_outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat_outputs(o)]
    return []


def replay(op: str, args, kwargs, device, wide: bool, seed: int) -> list:
    """The key's outputs on one route; a float64 kernel that refuses the
    layout runs on contiguous copies (that route alone)."""
    func = resolve(op)
    a, kw = build_args((args, kwargs), device, wide, seed)
    try:
        out = func(*a, **kw)
    except RuntimeError:
        if not wide:
            raise
        a, kw = build_args((args, kwargs), device, wide, seed,
                           contiguous=True)
        out = func(*a, **kw)
    return [t.detach() for t in flat_outputs(out)]


def _zero_extend(t: torch.Tensor, cut: torch.Tensor) -> None:
    """Element 0 of ``t`` becomes ``cut``'s element 0, zeros beyond it."""
    t[0].zero_()
    t[0][tuple(slice(0, s) for s in cut.shape[1:])] = cut[0]


def full_replay(rec: Record, cut_args, device, seed: int) -> list:
    """The key at its recorded shape on the card, drawn from the pool as
    ``element0_args``'s are; a convolution's tensors that the cut left
    whole are the cut's, and its batch inputs carry the cut's element 0
    (zero-extended). Returns its outputs."""
    a, kw = build_args((rec.args, rec.kwargs), device, False, seed)
    if rec.name in ("convolution", "convolution_backward"):
        cut, _ = build_args(cut_args, device, False, seed)
        a = list(a)
        for i, (t, c) in enumerate(zip(a, cut)):
            if not isinstance(t, torch.Tensor):
                continue
            if t.shape == c.shape:
                a[i] = c
            else:
                _zero_extend(t, c)
    return [t.detach() for t in flat_outputs(resolve(rec.op)(*a, **kw))]


def element0_outputs(rec: Record) -> tuple:
    """A convolution's outputs that depend on the first batch element
    alone: its output, convolution_backward's input gradient where it
    computes one (its first output then)."""
    if rec.name == "convolution" or (rec.name == "convolution_backward"
                                     and rec.args[10][0]):
        return (0,)
    return ()


def element0_args(rec: Record) -> Optional[tuple]:
    """(args, kwargs, outputs) of a key other than a convolution with each
    tensor that carries the batch cut to its first element (``of``) at its
    recorded length, and the outputs that depend on that element alone:
    those that keep their recorded shape but for a batch axis of 1 (the
    meta device decides). None where there are none."""
    if rec.name in ("convolution", "convolution_backward"):
        return None
    batch = rec.batch

    def walk(x):
        if isinstance(x, TensorSpec):
            if not (x.data and x.shape and x.shape[0] in batch):
                return x
            one = recut(x, (1,) + x.shape[1:])
            return dataclasses.replace(one, of=x)
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    args, kwargs = walk(rec.args), walk(rec.kwargs)
    if rec.name == "unfold_backward" and rec.args[1][0] in batch:
        args = (args[0], [1] + list(rec.args[1][1:])) + tuple(args[2:])
    if _signature((args, kwargs)) == _signature((rec.args, rec.kwargs)):
        return None
    try:
        full = flat_outputs(_meta_out(rec.op, rec.args, rec.kwargs))
        one = flat_outputs(_meta_out(rec.op, args, kwargs))
    except (RuntimeError, IndexError, ValueError, TypeError,
            NotImplementedError):
        return None
    outs = tuple(i for i, (f, o) in enumerate(zip(full, one))
                 if f.dim() and f.shape[0] in batch
                 and tuple(o.shape) == (1,) + tuple(f.shape[1:]))
    return (args, kwargs, outs) if outs else None


# --- the rule -------------------------------------------------------------

def rel_err(a: torch.Tensor, e: torch.Tensor) -> float:
    """max |a - e| / (1 + max |e|) over e's finite entries; inf where a is
    not finite there."""
    e = e.to(torch.complex128 if e.is_complex() else torch.float64)
    a = a.to(e.dtype)
    fin = torch.isfinite(e)
    if not bool(torch.isfinite(a[fin]).all()):
        return math.inf
    if not bool(fin.any()):
        return 0.0
    return ((a[fin] - e[fin]).abs().max()
            / (1 + e[fin].abs().max())).item()


def check_outputs(k: Sequence[torch.Tensor], p: Sequence[torch.Tensor],
                  e: Sequence[torch.Tensor]) -> List[dict]:
    """The rule of the module docstring for each output: ``err_k``,
    ``err_p`` (of 1 + max), ``factor`` (err_k / err_p), ``excess`` (past
    FACTOR x err_p + FLOOR), ``wrong`` (err_k past WRONG); an integer
    output counts the places each route leaves e."""
    out = []
    for tk, tp, te in zip(k, p, e):
        if tk.shape != te.shape or tp.shape != te.shape:
            out.append(dict(err_k=math.inf, err_p=0.0, factor=math.inf,
                            excess=True, wrong=True, integer=False))
            continue
        if not (te.is_floating_point() or te.is_complex()):
            dk = int((tk.cpu() != te).sum())
            dp = int((tp != te).sum())
            out.append(dict(err_k=float(dk), err_p=float(dp),
                            factor=1.0 if dk <= dp else math.inf,
                            excess=dk > dp, wrong=dk > dp, integer=True))
            continue
        ek, ep = rel_err(tk.cpu(), te), rel_err(tp, te)
        excess = not ek <= FACTOR * ep + FLOOR
        out.append(dict(err_k=ek, err_p=ep,
                        factor=(ek + 1e-12) / (ep + 1e-12), excess=excess,
                        wrong=not ek <= WRONG, integer=False))
    return out


def cpu_routes(task: dict) -> dict:
    """p and e of one key at its cut (this process's CPU, ``threads``), held
    with the card's outputs ``k`` by ``check_outputs``; a convolution's
    full-shape element-0 outputs ``k0`` against the cut's element 0; the
    full-shape element-0 outputs ``k1`` of another key against p and e of
    its ``element0`` arguments. What a process pool runs: the task is
    plain data."""
    if torch.get_num_threads() != task["threads"]:
        torch.set_num_threads(task["threads"])
    t0 = time.perf_counter()
    op, args, kwargs, seed = (task[k] for k in ("op", "args", "kwargs",
                                                "seed"))
    p = replay(op, args, kwargs, "cpu", False, seed)
    e = replay(op, args, kwargs, "cpu", True, seed)
    k = [torch.from_numpy(a) for a in task["k"]]
    results = check_outputs(k, p, e)
    for i, a in task.get("k0", {}).items():
        region = tuple(slice(0, s) for s in a.shape)
        (r,) = check_outputs([torch.from_numpy(a)], [p[i][0][region]],
                             [e[i][0][region]])
        results.append(dict(r, output=f"{i} at recipe shape"))
    if task.get("k1"):
        args1, kwargs1 = task["element0"]
        p1 = replay(op, args1, kwargs1, "cpu", False, seed)
        e1 = replay(op, args1, kwargs1, "cpu", True, seed)
        for i, a in task["k1"].items():
            (r,) = check_outputs([torch.from_numpy(a)], [p1[i]], [e1[i]])
            results.append(dict(r, output=f"{i} at recipe shape"))
    return {"index": task["index"], "results": results,
            "seconds": time.perf_counter() - t0}


# --- one step of a recipe -------------------------------------------------

def recipe_batch(config: Dict[str, Any], batch_size: int, device,
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """``engine.build.example_batch`` at the recipe's batch, a token
    generator's ids and durations drawn from ``seed`` over its vocabulary
    (the example's are all ones)."""
    from parallelwavegan_torch.engine.build import example_batch

    batch = example_batch(config, batch_size)
    gp = config.get("generator_params", {})
    rng = np.random.default_rng(seed)
    if "DiscreteSymbol" in config.get("generator_type", ""):
        c = batch["c"]
        c[..., 0] = rng.integers(0, gp.get("num_embs", 100), c.shape[:-1])
        if c.shape[-1] > 1:
            c[..., 1] = rng.integers(0, max(gp.get("num_spk_embs", 1), 1),
                                     c.shape[:-1])
        if "ds" in batch:
            batch["ds"] = rng.integers(0, 4, batch["ds"].shape).astype(
                np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def recipe_step(config: Dict[str, Any], device, seed: int = 0):
    """A closure running one f32 (G, adv, D) step of ``config`` at its
    batch on ``device``, the batch sizes the cut takes for a batch axis
    (the batch, and real and fake together), the step's input tensors and
    the shapes of the recipe's parameters and buffers."""
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.criterion import build_criterion
    from parallelwavegan_torch.engine.step import (
        DROPOUT_STREAM,
        SHARED_STREAM,
        build_steps,
        step_generator,
    )

    config = dict(config, mixed_precision=False)
    state, gen, dis, opt_g, opt_d = init_train_state(config, seed, device)
    factory, _ = build_steps(config, gen, dis,
                             build_criterion(config), opt_g,
                             opt_d)
    step = factory(True, True, True)
    B = config["batch_size"]
    batch = recipe_batch(config, B, device, seed)

    def run():
        step(state, batch, rng=step_generator(seed, 0),
             shared_rng=step_generator(seed, 0, SHARED_STREAM),
             dropout_rng=step_generator(seed, 0, DROPOUT_STREAM, device))
    static = {tuple(t.shape) for m in (gen, dis)
              for t in (*m.parameters(), *m.buffers())}
    return run, (B, 2 * B), list(batch.values()), static


def record(recipes: Dict[str, Dict[str, Any]], device
           ) -> Dict[tuple, Record]:
    """The distinct checked keys of one f32 step of each recipe (name ->
    config), the first recipe to make a key naming it."""
    census = Census()
    for name, config in recipes.items():
        run, batch, inputs, static = recipe_step(config, device)
        census.start(name, batch, inputs, static)
        with census:
            run()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        del run
    return census.records


def run_census(recipes: Dict[str, Dict[str, Any]], device, pool=None
               ) -> dict:
    """Record ``recipes``' steps on ``device``, replay every key on the
    card (cut and at its recorded shape) and, on ``pool`` (a
    ``concurrent.futures`` executor; inline without one), the CPU routes;
    returns ``{"keys": [...], "kinds": {...}, "seconds": {...}}``."""
    # a pool's processes take one thread each; inline, the caller's
    threads = 1 if pool is not None else torch.get_num_threads()
    t0 = time.perf_counter()
    records = list(record(recipes, device).values())
    t_record = time.perf_counter() - t0
    futures, keys, pending = [], [], []
    for index, rec in enumerate(records):
        for args, kwargs in cut_candidates(rec):
            try:
                k = replay(rec.op, args, kwargs, device, False, index)
                break
            except (RuntimeError, IndexError, ValueError) as err:
                if args is rec.args:
                    raise RuntimeError(
                        f"op census: {rec.op} ({rec.recipe}) does not "
                        f"replay: {err}; recorded {rec.args}") from err
        was_cut = args is not rec.args
        full = full_replay(rec, (args, kwargs), device, index)
        finite = all(bool(torch.isfinite(t).all()) for t in full
                     if t.is_floating_point() or t.is_complex())
        k0, k1, first = {}, {}, None
        if was_cut:
            for i in element0_outputs(rec):
                k0[i] = full[i][0][tuple(slice(0, s) for s in
                                         k[i].shape[1:])].cpu().numpy()
            first = element0_args(rec)
            if first is not None:
                k1 = {i: full[i][:1].cpu().numpy() for i in first[2]}
        task = dict(index=index, op=rec.op, args=args, kwargs=kwargs,
                    seed=index, threads=threads,
                    k=[t.cpu().numpy() for t in k], k0=k0, k1=k1,
                    element0=first and first[:2])
        keys.append(dict(kind=op_kind(rec), op=rec.op, recipe=rec.recipe,
                         calls=rec.calls, cut=was_cut, full_finite=finite,
                         shapes=[t.shape for t in _tensors(rec.args)],
                         cut_shapes=[t.shape for t in _tensors(args)]))
        if pool is None:
            pending.append(cpu_routes(task))
        else:
            futures.append(pool.submit(cpu_routes, task))
        del k, full
    t_card = time.perf_counter() - t0 - t_record
    cpu_seconds = 0.0
    for done in pending + [f.result() for f in futures]:
        keys[done["index"]].update(results=done["results"],
                                   cpu_seconds=done["seconds"])
        cpu_seconds += done["seconds"]
    kinds = summarize(keys)
    return {"keys": keys, "kinds": kinds, "seconds": {
        "record": t_record, "card": t_card,
        "total": time.perf_counter() - t0, "cpu_routes": cpu_seconds}}


def _tensors(x) -> list:
    if isinstance(x, TensorSpec):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def summarize(keys: List[dict]) -> Dict[str, dict]:
    """Per op kind: keys, worst factor (card over CPU), worst card error
    and the recipe of each, keys past the rule, wrong keys."""
    kinds: Dict[str, dict] = {}
    for key in keys:
        row = kinds.setdefault(key["kind"], dict(
            keys=0, factor=0.0, factor_recipe="", err_k=0.0, err_recipe="",
            excess=0, wrong=0, calls=0, cut=0, cpu_seconds=0.0))
        row["keys"] += 1
        row["cpu_seconds"] += key.get("cpu_seconds", 0.0)
        row["calls"] += key["calls"]
        row["cut"] += key["cut"]
        res = key.get("results", [])
        floats = [r for r in res if not r["integer"]]
        if any(r["excess"] for r in res):
            row["excess"] += 1
            n, worst = row.setdefault("excess_by_recipe", {}).get(
                key["recipe"], (0, 0.0))
            row["excess_by_recipe"][key["recipe"]] = (n + 1, max(
                [worst] + [r["factor"] for r in res if r["excess"]]))
        if any(r["wrong"] for r in res) or not key["full_finite"]:
            row["wrong"] += 1
            key["wrong"] = True
        for r in floats:
            if r["factor"] > row["factor"]:
                row["factor"], row["factor_recipe"] = r["factor"], \
                    key["recipe"]
            if r["err_k"] > row["err_k"]:
                row["err_k"], row["err_recipe"] = r["err_k"], key["recipe"]
    return kinds


def report(result: dict, card: str = "", log=print) -> None:
    """One line per op kind, then the total; raises on a wrong key."""
    kinds = result["kinds"]
    width = max(len(k) for k in kinds) if kinds else 10
    log(f"op census: {len(result['keys'])} distinct checked keys "
        f"(card f32 k, CPU f32 p, CPU float64 e; rule |k - e| <= "
        f"{FACTOR:g} |p - e| + {FLOOR:g} of 1 + max, wrong past {WRONG:g})"
        + (f" on {card}" if card else ""))
    for kind, r in sorted(kinds.items()):
        log(f"  {kind:<{width}}  keys {r['keys']:4d} (cut {r['cut']:3d}, "
            f"calls {r['calls']:5d})  worst k/p {r['factor']:9.3f} "
            f"({r['factor_recipe']})  worst |k - e| {r['err_k']:.3e} "
            f"({r['err_recipe']})  past the rule {r['excess']}  wrong "
            f"{r['wrong']}  CPU {r['cpu_seconds']:.1f} s")
        if r.get("excess_by_recipe"):
            log(f"  {'':<{width}}  past the rule by recipe: " + ", ".join(
                f"{rec} {n} (worst k/p {f:.2f})" for rec, (n, f) in
                sorted(r["excess_by_recipe"].items())))
    total = {k: sum(r[k] for r in kinds.values())
             for k in ("keys", "calls", "excess", "wrong", "cut")}
    s = result["seconds"]
    log(f"op census total: {total['keys']} keys ({total['cut']} cut) of "
        f"{total['calls']} calls, {total['excess']} past the rule, "
        f"{total['wrong']} wrong; record {s['record']:.1f} s, card "
        f"{s['card']:.1f} s, all {s['total']:.1f} s (CPU routes "
        f"{s['cpu_routes']:.1f} s of worker time)")
    for key in result["keys"]:
        for r in key.get("results", []):
            if r["excess"] or r["wrong"]:
                log(f"    {'WRONG' if r['wrong'] else 'past the rule'}: "
                    f"{key['op']} ({key['recipe']}) output "
                    f"{r.get('output', '')} k {r['err_k']:.3e} p "
                    f"{r['err_p']:.3e} (x {r['factor']:.2f}); shapes "
                    f"{str(key['shapes'])[:300]} cut to "
                    f"{str(key['cut_shapes'])[:300]}")
    wrong = [k for k in result["keys"] if k.get("wrong")]
    if wrong:
        raise AssertionError(
            f"op census: {len(wrong)} keys give wrong results on the card, "
            f"first {wrong[0]['op']} ({wrong[0]['recipe']})")

