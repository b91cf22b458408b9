"""Serving traffic: one closed-loop client calling the serving API.

``decode`` calls ``InferenceModel.synthesize_batch`` on ``batch``
utterances a call, in draw order, bucketed as the traffic file says;
``single`` calls ``InferenceModel.inference`` on one utterance a call at
its exact length. Each call takes its noise from a ``torch.Generator``
seeded from (seed, call); the waveform a call returns is in host memory
when the call returns. Outputs of a seeded sample of the utterances, and
the longest served, are kept for the comparison with the reference
(``check_serving``), which runs after the window has closed and the
program is freed.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench.core import weights as weights_lib
from portbench.core.lengths import Assets, call_schedule, length_pool
from portbench.core.trace import Profiler, span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# utterances a run hands the reference (besides the longest served)
CHECKED = 48
# the share of the window a traced run profiles, at its end
TRACED_SHARE = 0.3


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed derived from the run's seed and a stream."""
    seq = np.random.SeedSequence([int(seed) % 2 ** 63, *stream])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def build_model(root: str, config: dict, serving: dict, tree, device: str):
    """The program's ``InferenceModel`` in the traffic's serving mode: the
    checkpoint read by the program's own loader, or the seeded tree."""
    from parallelwavegan_torch.utils.model_loader import (
        InferenceModel,
        load_model,
    )

    dtype = DTYPES[serving["dtype"]]
    spec = config["portbench"]["weights"]
    if spec["source"] == "gckpt":
        model = load_model(os.path.join(root, spec["path"]), config,
                           dtype=dtype, device=device)
    else:
        model = InferenceModel(config, {"params": weights_lib.nested(tree)},
                               dtype=dtype, device=device)
    if serving.get("mrf_kernel"):
        model.use_mrf_kernel(quant=serving["mrf_kernel"] == "int8",
                             calib_mels=serving.get("calib_mels"))
    return model


class Kept:
    """The outputs the reference checks: each utterance with probability
    ``rate`` (drawn from the seed), and the longest served."""

    def __init__(self, rate: float, seed: int):
        self.rate, self.seed = rate, seed
        self.sampled: Dict[tuple, dict] = {}
        self.longest: Optional[dict] = None

    def offer(self, rec: dict, waves: List[np.ndarray]) -> None:
        u = np.random.default_rng([self.seed, rec["call"]]).random(
            len(rec["lengths"]))
        for j, n in enumerate(rec["lengths"]):
            take = u[j] < self.rate
            longest = self.longest is None or n > self.longest["length"]
            if not (take or longest):
                continue
            item = {"call": rec["call"], "index": j, "length": n,
                    "frames": rec["frames"], "batch": len(rec["lengths"]),
                    "wave": np.array(waves[j], copy=True)}
            if take:
                self.sampled[(rec["call"], j)] = item
            if longest:
                self.longest = item

    def items(self) -> List[dict]:
        out = dict(self.sampled)
        if self.longest is not None:
            out[(self.longest["call"], self.longest["index"])] = self.longest
        return [out[k] for k in sorted(out)]


class _Observer:
    """Spans inside one serving call, for the traced stretch only: the
    host preparation (``prepare``) and the device call (``forward``) of
    ``prepare_batch``; the rest of the call span is the readback and the
    crop. Set as an instance attribute, so the program runs as it is."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        original = self.model.prepare_batch

        def prepare_batch(*args, **kwargs):
            with span("prepare"):
                fn, inputs, lengths = original(*args, **kwargs)

            def forward(*a, **k):
                with span("forward"):
                    return fn(*a, **k)

            return forward, inputs, lengths

        self.model.prepare_batch = prepare_batch
        return self

    def __exit__(self, *exc):
        del self.model.prepare_batch
        return False


class Serving:
    """The cell's inputs, the program and the closed loop."""

    def __init__(self, root: str, config: dict, traffic: dict, seed: int,
                 device: str, clock: Dict[str, float]):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.hop, self.sr = config["hop_size"], config["sampling_rate"]
        self.single = traffic["kind"] == "single"
        self.bucket = 1 if self.single else traffic["bucket_frames"]
        serving = dict(traffic["serving"])

        t = time.perf_counter()
        assets = Assets(root)
        self.pool = length_pool(traffic["lengths"])
        rng = np.random.default_rng(sub_seed(seed, 1))
        self.mels = [assets.utterance(int(n), rng)[0] for n in self.pool]
        if serving.get("mrf_kernel") == "int8":
            serving["calib_mels"] = assets.mels[:8]
        self.order = call_schedule(traffic["lengths"], traffic["batch"],
                                   np.random.default_rng(sub_seed(seed, 2)))
        self.calls: List[np.ndarray] = []
        self.cycle = traffic["lengths"]["pool"] // traffic["batch"]
        clock["data"] = time.perf_counter() - t

        t = time.perf_counter()
        self.tree = weights_lib.generator_tree(root, config, seed, device)
        self.model = build_model(root, config, serving, self.tree, device)
        clock["weights"] = time.perf_counter() - t

    def utterances(self, i: int) -> np.ndarray:
        """Pool indices of call ``i`` of the schedule."""
        while len(self.calls) <= i:
            self.calls.append(next(self.order))
        return self.calls[i]

    def frames(self, i: int) -> int:
        longest = int(max(self.pool[self.utterances(i)]))
        return -(-longest // self.bucket) * self.bucket

    def noise_seed(self, i: int) -> int:
        return sub_seed(self.seed, 3, i)

    def call(self, i: int) -> List[np.ndarray]:
        cs = [self.mels[j] for j in self.utterances(i)]
        gen = torch.Generator(device=self.device).manual_seed(
            self.noise_seed(i))
        with span("call"):
            if self.single:
                return [self.model.inference(cs[0], generator=gen)]
            return self.model.synthesize_batch(cs, generator=gen,
                                               bucket_size=self.bucket)

    def warm_up(self) -> float:
        """One call of each shape the schedule reaches (a cycle holds
        every batch); the median time a call took, the first (which meets
        the card's lazy set-up) left out."""
        first = {}
        for i in range(self.cycle):
            first.setdefault(self.frames(i), i)
        times = []
        for i in first.values():
            t = time.perf_counter()
            self.call(i)
            times.append(time.perf_counter() - t)
        if self.device == "cuda":
            torch.cuda.synchronize()
        rest = sorted(times[1:] or times)
        return rest[len(rest) // 2]

    def window(self, seconds: float, trace: bool, call_seconds: float
               ) -> Dict[str, Any]:
        """Calls back to back until ``seconds`` have passed; with
        ``trace``, the last ``TRACED_SHARE`` of the window (two calls at
        the least) is profiled."""
        traffic = self.traffic
        expected = max(1.0, seconds / max(call_seconds, 1e-4))
        kept = Kept(min(1.0, CHECKED / (expected * traffic["batch"])),
                    sub_seed(self.seed, 4))
        prof = Profiler() if trace else None
        observer = _Observer(self.model)
        traced_from = 0
        records: List[dict] = []
        failed = 0
        t0 = time.perf_counter()
        i = 0
        while True:
            elapsed = time.perf_counter() - t0
            if prof is not None and not prof.active and seconds - elapsed \
                    <= max(TRACED_SHARE * seconds, 2 * call_seconds):
                prof.start()
                observer.__enter__()
                traced_from = len(records)
            # a traced run traces one call at the least
            if elapsed >= seconds and (prof is None
                                       or len(records) > traced_from):
                break
            try:
                records.append(self._timed(i, kept))
            except RuntimeError as e:  # a call the program could not serve
                lengths = [int(n) for n in self.pool[self.utterances(i)]]
                failed += len(lengths)
                records.append({"call": i, "lengths": lengths,
                                "frames": self.frames(i),
                                "error": str(e)[:300],
                                "start": time.perf_counter(),
                                "end": time.perf_counter()})
            i += 1
        t1 = records[-1]["end"]
        peak = (torch.cuda.max_memory_allocated()
                if self.device == "cuda" else 0)
        out = {"t0": t0, "t1": t1, "kept": kept, "failed": failed,
               "records": records, "memory_peak": peak,
               "attempted": sum(len(r["lengths"]) for r in records)}
        if prof is not None and prof.active:
            observer.__exit__()
            out["trace"] = prof.stop()
            out["traced_calls"] = records[traced_from:]
        for r in records:
            r["audio_s"] = 0.0 if "error" in r else \
                sum(r["lengths"]) * self.hop / self.sr
        return out

    def _timed(self, i: int, kept: Kept) -> dict:
        lengths = [int(n) for n in self.pool[self.utterances(i)]]
        start = time.perf_counter()
        waves = self.call(i)
        end = time.perf_counter()
        rec = {"call": i, "lengths": lengths, "frames": self.frames(i),
               "start": start, "end": end}
        kept.offer(rec, waves)
        return rec

    def free_program(self) -> None:
        self.model = None

    def check(self, kept: Kept) -> Dict[str, float]:
        """The numbers ``correct`` is decided on: the kept waveforms
        against the reference's."""
        items = kept.items()
        return compare_waves([it["wave"] for it in items],
                             reference_waves(self, items))

    def close(self) -> None:
        pass


def reference_waves(serving: Serving, items: List[dict],
                    tf32: bool = False) -> List[np.ndarray]:
    """The reference's waveform of each kept utterance, from the same
    mels, noise and weights, padded as the serving API pads it, in
    float32 with TF32 off (on for ``tf32``: the control)."""
    config = serving.config
    gp = config["generator_params"]
    ref = weights_lib.reference_module(config)
    params = {k: v.to(serving.device) for k, v in weights_lib.folded(
        {k: v.cpu() for k, v in serving.tree.items()}, ref).items()}
    ctx = ref.context_frames(gp)
    dtype = DTYPES[serving.traffic["serving"]["dtype"]]
    hop = serving.hop
    out: Dict[tuple, np.ndarray] = {}
    by_call: Dict[int, List[dict]] = {}
    for item in items:
        by_call.setdefault(item["call"], []).append(item)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for call, group in by_call.items():
            frames = group[0]["frames"]
            z_all = None
            if ref.NOISE:
                gen = torch.Generator(device=serving.device).manual_seed(
                    serving.noise_seed(call))
                z_all = torch.randn(
                    (group[0]["batch"], frames * hop, gp["in_channels"]),
                    generator=gen, device=serving.device, dtype=dtype).float()
            for k in range(0, len(group), 4):
                part = group[k:k + 4]
                mels = [serving.mels[serving.utterances(call)[it["index"]]]
                        for it in part]
                c = np.stack([np.pad(m, ((ctx, frames - len(m) + ctx),
                                         (0, 0)), mode="edge")
                              for m in mels])
                c = torch.from_numpy(c).to(serving.device)
                z = None if z_all is None else \
                    z_all[[it["index"] for it in part]]
                with torch.no_grad():
                    r = ref.generator(params, gp, c, z).float().cpu().numpy()
                for it, row in zip(part, r):
                    out[(it["call"], it["index"])] = row[:it["length"] * hop]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return [out[(it["call"], it["index"])] for it in items]


def compare_waves(got: List[np.ndarray], want: List[np.ndarray]
                  ) -> Dict[str, float]:
    """The worst per-utterance max |y - r| / max |r| and RMS(y - r) /
    RMS(r); infinite where a shape differs or a value is not finite."""
    worst_max, worst_rms = 0.0, 0.0
    for y, r in zip(got, want):
        y, r = np.asarray(y, np.float64), np.asarray(r, np.float64)
        if y.shape != r.shape or not np.isfinite(y).all():
            return {"wave_max_err": float("inf"),
                    "wave_rms_err": float("inf")}
        d = y - r
        worst_max = max(worst_max,
                        float(np.abs(d).max() / max(np.abs(r).max(), 1e-12)))
        worst_rms = max(worst_rms, float(np.sqrt(
            np.mean(d ** 2) / max(np.mean(r ** 2), 1e-30))))
    return {"wave_max_err": worst_max, "wave_rms_err": worst_rms}
