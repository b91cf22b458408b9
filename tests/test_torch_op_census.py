"""The op census's machinery (parallelwavegan_torch/tools/op_census.py) on
the CPU: what it records of small MelGAN and HiFi-GAN steps, how it cuts
and replays a key, and its rule. The census itself runs on the card
(chip_smoke.py step 19)."""

import pickle

import pytest
import torch
import torch.nn.functional as F

from parallelwavegan_torch.tools import op_census
from tests.torch_helpers import (
    small_hifigan_train_config,
    small_melgan_train_config,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def records():
    """The census of one f32 step of the small multi-band MelGAN recipe
    and of the small HiFi-GAN recipe, on the CPU."""
    recipes = {"mb_melgan": small_melgan_train_config("mb_melgan"),
               "hifigan": small_hifigan_train_config()}
    return list(op_census.record(recipes, "cpu").values())


def _find(records, kind, recipe=None):
    return [r for r in records if op_census.op_kind(r) == kind
            and (recipe is None or r.recipe == recipe)]


@pytest.mark.parametrize("kind, recipe", [
    ("convolution (1d)", "mb_melgan"),
    ("convolution_backward (1d)", "mb_melgan"),
    ("convolution (1d, transposed)", "mb_melgan"),
    ("convolution_backward (1d, transposed)", "hifigan"),
    ("convolution (1d, grouped, strided)", "mb_melgan"),
    ("convolution_backward (1d, grouped, strided)", "mb_melgan"),
    ("reflection_pad1d", "mb_melgan"),
    ("reflection_pad1d_backward", "mb_melgan"),
    ("convolution (2d)", "hifigan"),
    ("convolution_backward (2d)", "hifigan"),
    ("linalg_vector_norm", "hifigan"),
    ("mv", "hifigan"),
])
def test_census_finds_the_expected_keys(records, kind, recipe):
    """Each kind in the step that makes it, with its recipe's batch sizes
    and the port's layout kept in the key's strides."""
    found = _find(records, kind, recipe)
    assert found, kind
    assert all(r.batch[1] == 2 * r.batch[0] for r in found)


def test_census_leaves_out_pointwise_ops_and_counts_calls(records):
    names = {r.name for r in records}
    assert not names & op_census.LEFT_OUT
    assert {"add", "mul", "leaky_relu", "leaky_relu_backward", "where",
            "tanh", "sigmoid", "copy_", "view"} <= op_census.LEFT_OUT
    assert sum(r.calls for r in records) > len(records)
    # a key's layout: the port's channels-last activations reach the convs
    # as transposed views, and the key keeps those strides
    conv = _find(records, "convolution (1d)", "mb_melgan")
    assert any(r.args[0].stride[1] == 1 for r in conv)


def test_cut_keeps_layout_kernel_and_cuts_batch_and_time():
    """A grouped strided conv of batch 16 x 16,384 frames, channels-last:
    cut to batch 2 and max(2,048, 4 receptive fields) frames, the
    strides' order and every other argument kept; its backward's
    gradient takes the cut forward's length."""
    x = op_census.TensorSpec((16, 64, 16384), (64 * 16384, 1, 64),
                             torch.float32)
    w = op_census.TensorSpec((256, 4, 41), (164, 41, 1), torch.float32)
    fwd = op_census.Record("aten.convolution.default",
                           (x, w, None, [4], [20], [1], False, [0], 16), {},
                           "melgan", (16, 32))
    (args, _), *_ = op_census.cut_candidates(fwd)
    assert args[0].shape == (2, 64, 2048)
    assert args[0].stride == op_census.dense_strides((2, 64, 2048),
                                                     x.stride)
    assert args[0].stride[1] == 1 and args[1:] == fwd.args[1:]
    g = op_census.TensorSpec((16, 256, 4096), (256 * 4096, 1, 256),
                             torch.float32)
    bwd = op_census.Record(
        "aten.convolution_backward.default",
        (g, x, w, [256], [4], [20], [1], False, [0], 16,
         [True, True, True]), {}, "melgan", (16, 32))
    (args, _), *_ = op_census.cut_candidates(bwd)
    assert args[0].shape == (2, 256, 512) and args[1].shape == (2, 64, 2048)
    # a long receptive field keeps four of them
    wide = op_census.TensorSpec((8, 8, 1025), (8200, 1025, 1), torch.float32)
    x2 = op_census.TensorSpec((16, 8, 16384), (8 * 16384, 16384, 1),
                              torch.float32)
    rec = op_census.Record("aten.convolution.default",
                           (x2, wide, None, [1], [0], [1], False, [0], 1),
                           {}, "r", (16, 32))
    (args, _), *_ = op_census.cut_candidates(rec)
    assert args[0].shape == (2, 8, 4 * 1025)


def test_a_recorded_key_replays_bit_for_bit(records):
    """A recorded conv key replays twice to the same bits, and to the
    bits of the op called on the same drawn inputs; the float64 route
    draws the same values."""
    rec = _find(records, "convolution (1d, grouped, strided)",
                "mb_melgan")[0]
    args, kwargs = op_census.cut_candidates(rec)[0]
    a = op_census.replay(rec.op, args, kwargs, "cpu", False, 3)
    b = op_census.replay(rec.op, args, kwargs, "cpu", False, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    x, w, bias = op_census.build_args(args[:3], "cpu", False, 3)
    assert x.stride() == args[0].stride
    want = F.conv1d(x, w, bias, stride=args[3], padding=args[4],
                    dilation=args[5], groups=args[8])
    assert torch.equal(a[0], want)
    x64 = op_census.build_args(args[:1], "cpu", True, 3)[0]
    assert x64.dtype == torch.float64 and torch.equal(x64.float(), x)


def test_check_passes_a_correct_route_and_flags_a_wrong_gradient(records):
    """The rule on a recorded conv backward: the CPU's own f32 route
    passes; a route whose input gradient is off by 1e-3 of its largest
    entry at one place is past the rule and wrong."""
    rec = _find(records, "convolution_backward (1d)", "mb_melgan")[0]
    args, kwargs = op_census.cut_candidates(rec)[0]
    p = op_census.replay(rec.op, args, kwargs, "cpu", False, 1)
    e = op_census.replay(rec.op, args, kwargs, "cpu", True, 1)
    ok = op_census.check_outputs(p, p, e)
    assert not any(r["excess"] or r["wrong"] for r in ok)
    bad = [t.clone() for t in p]
    bad[0].view(-1)[7] += 1e-3 * bad[0].abs().max()
    flagged = op_census.check_outputs(bad, p, e)
    assert flagged[0]["excess"] and flagged[0]["wrong"]
    assert not any(r["excess"] for r in flagged[1:])
    # a route as far from float64 as the CPU's f32 but past 1e-4 is within
    # the rule, and wrong all the same: 1e-4 is the f32 correctness limit
    far = op_census.check_outputs([e[0] + 2e-4 * (1 + e[0].abs().max())],
                                  [e[0] - 2e-4 * (1 + e[0].abs().max())],
                                  [e[0]])
    assert not far[0]["excess"] and far[0]["wrong"]


def test_cpu_routes_task_is_plain_data_for_a_process_pool(records):
    """What the census hands its pool pickles, and the worker's answer
    holds the card's outputs (here the CPU's) and the element-0 outputs
    at the recipe shape to the rule."""
    rec = _find(records, "convolution (1d, transposed)", "mb_melgan")[0]
    args, kwargs = op_census.cut_candidates(rec)[0]
    k = op_census.replay(rec.op, args, kwargs, "cpu", False, 0)
    full = op_census.full_replay(rec, (args, kwargs), "cpu", 0)
    k0 = {0: full[0][0][tuple(slice(0, s) for s in k[0].shape[1:])].numpy()}
    task = dict(index=0, op=rec.op, args=args, kwargs=kwargs, seed=0,
                threads=2, k=[t.numpy() for t in k], k0=k0)
    done = op_census.cpu_routes(pickle.loads(pickle.dumps(task)))
    assert len(done["results"]) == 2
    assert not any(r["excess"] or r["wrong"] for r in done["results"])


def test_cut_leaves_parameters_and_constants_whole():
    """Only tensors derived from the batch are cut, and only along the
    batch and time: a tensor of a parameter's shape (a gradient) and a
    constant (the STFT basis of fft 2,048, 2,050 columns) stay whole, and
    so does an axis of the batch's tensors that meets a constant's."""
    spec = op_census.TensorSpec
    a = spec((4416, 2048), (2048, 1), torch.float32, data=True)
    basis = spec((2048, 2050), (2050, 1), torch.float32)
    fwd = op_census.Record("aten.mm.default", (a, basis), {}, "r", (64, 128))
    (args, _), *_ = op_census.cut_candidates(fwd)
    assert args[0].shape == (2048, 2048) and args[1] is basis
    cot = spec((4416, 2050), (2050, 1), torch.float32, data=True)
    basis_t = spec((2050, 2048), (1, 2050), torch.float32)
    bwd = op_census.Record("aten.mm.default", (cot, basis_t), {}, "r",
                           (64, 128))
    (args, _), *_ = op_census.cut_candidates(bwd)
    assert args[0].shape == (2048, 2050) and args[1] is basis_t
    grads = [spec((16, 8, 3), (24, 3, 1), torch.float32),
             spec((16,), (1,), torch.float32)]
    norm = op_census.Record("aten._foreach_norm.Scalar", (grads, 2), {},
                            "r", (16, 32))
    assert [t.shape for t in op_census.cut_candidates(norm)[0][0][0]] == [
        (16, 8, 3), (16,)]


def test_census_marks_what_the_batch_makes(records):
    """Activations and their gradients are derived from the batch; the
    parameters, the weight norm's products and the parameters'
    gradients are not."""
    conv = _find(records, "convolution (1d)", "mb_melgan")
    assert all(r.args[0].data and not r.args[1].data for r in conv)
    norm = _find(records, "linalg_vector_norm", "hifigan")
    assert norm and not any(r.args[0].data for r in norm)
    bwd = _find(records, "convolution_backward (1d)", "mb_melgan")
    assert all(r.args[0].data and r.args[1].data for r in bwd)


def test_element0_of_a_key_at_recipe_shape(records):
    """A reflect pad, its backward and the STFT frames' backward depend on
    each batch element alone: their first element at the recorded shape
    replays on the CPU routes from the first element of the full draw, and
    a worker holds it to the rule; a reduction over the batch does not."""
    for kind in ("reflection_pad1d", "reflection_pad1d_backward",
                 "unfold_backward"):
        rec = _find(records, kind, "mb_melgan")[0]
        first = op_census.element0_args(rec)
        assert first is not None and first[2] == (0,), kind
        args, kwargs = op_census.cut_candidates(rec)[0]
        full = op_census.full_replay(rec, (args, kwargs), "cpu", 5)
        one = op_census.replay(rec.op, *first[:2], "cpu", False, 5)
        assert torch.equal(one[0], full[0][:1]), kind
        task = dict(index=0, op=rec.op, args=args, kwargs=kwargs, seed=5,
                    threads=2, k=[t.numpy() for t in op_census.replay(
                        rec.op, args, kwargs, "cpu", False, 5)],
                    k0={}, k1={0: full[0][:1].numpy()},
                    element0=first[:2])
        done = op_census.cpu_routes(pickle.loads(pickle.dumps(task)))
        assert [r.get("output") for r in done["results"]] == [
            None, "0 at recipe shape"], kind
        assert not any(r["wrong"] for r in done["results"])
    spec = op_census.TensorSpec
    x = spec((16, 8, 4096), (8 * 4096, 4096, 1), torch.float32, data=True)
    over_batch = op_census.Record("aten.sum.dim_IntList", (x, [0]), {}, "r",
                                  (16, 32))
    assert op_census.element0_args(over_batch) is None


def test_summary_and_report_raise_on_a_wrong_key():
    keys = [dict(kind="mm", op="aten.mm.default", recipe="r", calls=3,
                 cut=True, full_finite=True, shapes=[], cut_shapes=[],
                 results=[dict(err_k=1e-3, err_p=1e-7, factor=1e4,
                               excess=True, wrong=True, integer=False)]),
            dict(kind="mm", op="aten.mm.default", recipe="s", calls=1,
                 cut=False, full_finite=True, shapes=[], cut_shapes=[],
                 results=[dict(err_k=1e-7, err_p=1e-7, factor=1.0,
                               excess=False, wrong=False, integer=False)])]
    kinds = op_census.summarize(keys)
    assert kinds["mm"]["keys"] == 2 and kinds["mm"]["wrong"] == 1
    assert kinds["mm"]["factor_recipe"] == "r"
    lines = []
    with pytest.raises(AssertionError, match="1 keys give wrong"):
        op_census.report({"keys": keys, "kinds": kinds, "seconds": dict(
            record=0.0, card=0.0, total=0.0, cpu_routes=0.0)},
            log=lines.append)
    assert any(line.strip().startswith("mm") for line in lines)
    assert kinds["mm"]["excess_by_recipe"] == {"r": (1, 1e4)}
    assert any("past the rule by recipe: r 1 (worst k/p 10000.00)" in line
               for line in lines)


def test_census_recipes_are_the_recipes_chip_smoke_trains():
    """Step 19's eight recipes are the dicts the training steps use (each
    held to its yaml by its own test), at their batch."""
    import chip_smoke

    recipes = chip_smoke.CENSUS_RECIPES
    assert list(recipes) == ["PWG v1", "HiFi-GAN v1", "MB-MelGAN v2",
                             "PWG v3", "StyleMelGAN v1", "VQ-VAE",
                             "UHiFiGAN", "duration"]
    assert recipes["PWG v1"] is chip_smoke.PWG_V1
    assert recipes["HiFi-GAN v1"] is chip_smoke.HIFIGAN_V1_TRAIN
    assert recipes["PWG v3"]["fused_wavenet"] is False
    assert recipes["VQ-VAE"]["hop_size"] == 64
    assert recipes["duration"]["generator_type"] == (
        "DiscreteSymbolDurationGenerator")
    for name, config in recipes.items():
        short = dict(config, batch_max_steps=16 * config["hop_size"])
        batch = op_census.recipe_batch(short, 2, "cpu")
        assert batch["y"].shape[:2] == (2, 16 * config["hop_size"]), name
