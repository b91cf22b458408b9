"""A run with the timed path broken underneath comes out not correct:
one run for each fault a cell can have (an answer altered where it is
produced; a training step that returns its state unchanged; half of the
batch left out, the mean taken over the rest). One card: no exchange
between chips to leave out."""

import pytest

from portbench.tests.support import ROOT, run_toy, toy_sizes


def _altered_waves(monkeypatch):
    from parallelwavegan_torch.utils.model_loader import InferenceModel

    real = InferenceModel.synthesize_batch

    def altered(self, *args, **kwargs):
        waves = real(self, *args, **kwargs)
        waves[0] = waves[0] * 1.1  # one utterance 10 % too loud
        return waves

    monkeypatch.setattr(InferenceModel, "synthesize_batch", altered)


@pytest.mark.parametrize("cell", ["pwg_v1.decode_ljspeech_b32_f32",
                                  "pwg_v1.tts_ljspeech_b1_f32",
                                  "hifigan_v1.decode_ljspeech_b32_mrf_bf16"])
def test_an_altered_answer_fails(monkeypatch, cell):
    _altered_waves(monkeypatch)
    with toy_sizes(monkeypatch):
        result, checks = run_toy(ROOT, cell, seconds=0.3)
    assert not result["correct"], checks


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from parallelwavegan_torch.engine import trainer as trainer_lib

    def frozen(self, batch):
        self.state.steps += 1
        self.steps += 1
        for k in ("generator_loss", "discriminator_loss"):
            self.total_train_loss[f"train/{k}"] += 1.0

    monkeypatch.setattr(trainer_lib.Trainer, "_train_step", frozen)
    with toy_sizes(monkeypatch):
        result, checks = run_toy(ROOT, "pwg_v1.train_adv_b6_f32",
                                 seconds=0.3)
    assert not result["correct"], checks
    assert checks["change_gap"][0] > 0.5


def test_half_the_batch_left_out_fails(monkeypatch):
    from parallelwavegan_torch.engine import trainer as trainer_lib

    real = trainer_lib.Trainer._train_step

    def half(self, batch):
        n = len(batch["y"]) // 2
        return real(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(trainer_lib.Trainer, "_train_step", half)
    with toy_sizes(monkeypatch):
        result, checks = run_toy(ROOT, "pwg_v1.train_adv_b6_f32",
                                 seconds=0.3)
    assert not result["correct"], checks


def test_a_rectified_update_without_its_factor_fails(monkeypatch):
    """RAdam's rectified branch (from its sixth update on, as every step
    of the window runs it) with its rectification factor left out: the
    checked steps reach it, and the change after them comes out wrong."""
    import math

    import torch

    from parallelwavegan_torch import optimizers

    real = optimizers._ScaleByAdam.update

    def unrectified(self, updates, state, params):
        out = real(self, updates, state, params)
        t, b2 = state["count"], self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2 * t * b2 ** t / (1 - b2 ** t)
        if self.rectified and ro >= self.threshold:
            rect = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                             / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            torch._foreach_div_(out, rect)
        return out

    monkeypatch.setattr(optimizers._ScaleByAdam, "update", unrectified)
    with toy_sizes(monkeypatch):
        result, checks = run_toy(ROOT, "pwg_v1.train_adv_b6_f32",
                                 seconds=0.3)
    assert not result["correct"], checks
    assert checks["change_gap"][0] > checks["change_gap"][1]
