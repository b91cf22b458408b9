"""The frozen counts reproduce the figures the port's records hold
(PERF.md's kernel table, rounded to three digits: hence 5e-3), and the
peaks are fixed by dtype."""

import json
import os

import pytest

from portbench.core import yardstick as ys
from portbench.tests.support import ROOT


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_b1_serving_operations():
    assert ys.stack_flops(32, 131072, 30) == pytest.approx(1.08e13, rel=5e-3)


def test_b1_b2_training_operations():
    assert ys.stack_flops(6, 25600, 30) == pytest.approx(3.96e11, rel=5e-3)
    assert ys.backward_flops(6, 25600, 30) == pytest.approx(1.11e12,
                                                            rel=5e-3)


def test_b3_operations_at_32_by_512_frames():
    gp = _config("hifigan_v1")["generator_params"]
    total = sum(ys.mrf_flops(rows, C, gp["resblock_kernel_sizes"], 3)
                for rows, C in ys.hifigan_mrf_stage_rows(gp, 32, 512)
                .values())
    assert total == pytest.approx(9.74e12, rel=5e-3)


def test_model_counts():
    from portbench.counts import hifigan, parallel_wavegan

    pwg, hifi = _config("pwg_v1"), _config("hifigan_v1")
    # the stack is all but a fraction of a percent of the forward
    per_sample = parallel_wavegan.generator_flops_per_sample(
        pwg["generator_params"], pwg["hop_size"])
    assert per_sample == pytest.approx(
        ys.stack_flops(1, 1, 30), rel=5e-3)
    assert hifigan.generator_flops_per_frame(hifi["generator_params"]) \
        == pytest.approx(613e6, rel=5e-3)
    step = parallel_wavegan.train_step_flops(pwg, 6, 25600)
    assert step == pytest.approx(
        4 * parallel_wavegan.forward_flops(pwg, 6 * 25600)
        + 8 * 197376 * 6 * 25600, rel=1e-9)


def test_each_configuration_names_its_counts():
    from portbench.core.manifest import plugin

    for name, family in (("pwg_v1", "parallel_wavegan"),
                         ("hifigan_v1", "hifigan")):
        counts = plugin(_config(name), "counts")
        assert counts.__name__ == f"portbench.counts.{family}"
        assert counts.forward_flops(_config(name), 256) > 0


def test_peaks_are_fixed_by_dtype():
    assert ys.PEAK_FLOPS == {"float32": 495e12, "bfloat16": 989e12}
    assert ys.PEAK_BYTES_PER_S == 3.35e12
    # B1 at the serving shape is bound by operations at the f32 peak
    B, T, L = 32, 131072, 30
    least = ys.least_seconds(ys.stack_flops(B, T, L),
                             ys.stack_bytes(B, T, L, "float32"), "float32")
    assert least == pytest.approx(1.08e13 / 495e12, rel=5e-3)
