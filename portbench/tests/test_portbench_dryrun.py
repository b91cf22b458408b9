"""Each traffic kind run at toy size on the CPU, against the reference:
the whole run path but the look for a card (the program's CPU paths: the
plain per-layer forward, the MRF kernel's plain version, the per-layer
training step)."""

import pytest

from portbench.tests.support import ROOT, run_toy, toy_sizes

CELLS = ["pwg_v1.decode_ljspeech_b32_f32", "pwg_v1.tts_ljspeech_b1_f32",
         "hifigan_v1.decode_ljspeech_b32_mrf_bf16", "pwg_v1.train_adv_b6_f32"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_toy_run_is_correct(monkeypatch, cell, trace):
    with toy_sizes(monkeypatch):
        result, checks = run_toy(ROOT, cell, trace)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    if not trace:
        assert "setup_s" in result["metrics"]
        assert len(result["metrics"]) == 2
    else:
        # the CPU run has no device time: busy 0, idle 100 %
        assert result["device"]["window_s"] > 0
        assert result["breakdown"]["idle_gaps"]
    for value, limit in checks.values():
        assert value <= limit


@pytest.mark.parametrize("cell,seconds", [
    ("pwg_v1.train_adv_b6_f32", 0.05),
    ("pwg_v1.decode_ljspeech_b32_f32", 0.005),
])
def test_a_traced_run_traces_a_step_that_crosses_the_end(monkeypatch, cell,
                                                          seconds):
    """The warm-up's time a unit set to 0 and a window shorter than a
    unit: the first unit crosses the window's end before the profiler
    starts, and the run still traces one."""
    from portbench.core import serve, train

    real_train, real_serve = train.Training.warm_up, serve.Serving.warm_up

    def fast_train(self, steps):
        real_train(self, steps)
        self.step_seconds = 0.0

    monkeypatch.setattr(train.Training, "warm_up", fast_train)
    monkeypatch.setattr(serve.Serving, "warm_up",
                        lambda self: real_serve(self) * 0.0)
    with toy_sizes(monkeypatch):
        result, checks = run_toy(ROOT, cell, True, seconds=seconds)
    assert result["correct"], checks
    assert result["device"]["window_s"] > 0
