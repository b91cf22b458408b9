#!/usr/bin/env python3
"""The recipe stage runner: stages 1-4 of ``egs/common/run_stages.sh``
through the port's CLIs.

Run it from a recipe directory (``egs/<corpus>/<task>``) after the recipe's
own stages -1 (download) and 0 (data preparation) have written
``data/{train,dev,eval}/wav.scp``: those two stages stay with the recipes'
shell functions (``download``, ``data_prep`` in each ``run.sh``), and this
module starts at stage 1.

    stage 1: features (round-robin ``wav.<j>.scp`` shards, one job each),
             statistics and normalization
    stage 2: training          stage 3: decoding
    stage 4: objective evaluation (MCD and log-F0 RMSE)

It keeps the shell's layout: ``dump/<set>/raw``, ``dump/<set>/norm``,
``dump/train/stats.h5`` (``stats.npy`` for a ``format: npy`` recipe, which
the shell's fixed ``stats.h5`` does not read) and ``stats-local.h5``,
``exp/<tag>/{train.log, checkpoint-*.ckpt, wav, gt_wav}`` (the scorers'
output printed, and kept in ``exp/<tag>/evaluate_{mcd,f0}.log``); and its
modes:
``--use-f0`` (f0 at preprocessing), ``--token-mode`` (``preprocess_tokens``
from ``data/<set>/text`` with utt2spk / spk2idx where present, no
statistics), ``--skip-normalize`` (``norm`` is a link to ``raw``), and
the local and global condition modes, read from the config's
``use_local_condition`` / ``use_global_condition`` (``--extract-f0``,
``--target-feats local``, ``--skip-wav-copy``; ``--utt2spk``). Stage 4's
ground-truth wavs come from the raw dumps through ``utils/io``.

Each preprocessing shard and the training job run as local subprocesses
(logs beside the dumps and in ``exp/<tag>/train.log``), or, with ``--cmd
"bash egs/common/run_job.sh"``, as ``<cmd> [--gpu 1] <logfile>
<command...>``, so the slurm, queue and ssh backends of that script work
as they do for the shell. The other stages run as subprocesses of their
own. The feature jobs of the three sets, the three normalizations and the
two scorers each start together (the shell runs them one set or one
scorer after another). ``--device`` goes to the CLIs that run on the card
(preprocess, train, decode; ``cuda`` by default):

    cd egs/ljspeech/voc1
    python -m parallelwavegan_torch.bin.run_stages \\
        --conf conf/parallel_wavegan.v1.yaml --stage 1 --stop-stage 4 \\
        --n-jobs 4 [--tag T] [--resume R] [--pretrain P] [--cmd C] \\
        [--device cpu]

``run`` is the same entry with the options as arguments; its
``in_process`` names CLIs (``"train"``, ``"decode"``) to call in this
process instead, their log lines written to the same files.
"""

from __future__ import annotations

import argparse
import glob
import importlib
import logging
import os
import shlex
import shutil
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

SETS = ("train", "dev", "eval")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Jobs:
    """Starts the CLIs of the port as jobs and waits for them: a job is
    ``python -m parallelwavegan_torch.bin.<module> args``, run through
    ``cmd`` (``<cmd> [--gpu 1] <log> <command...>``) when it is submitted
    and a ``cmd`` is given, else as a local subprocess (its output to
    ``log``, or to this process's output when there is no log), or in this
    process when its module is named in ``in_process``."""

    def __init__(self, cmd: Optional[str] = None,
                 in_process: Sequence[str] = ()):
        self.cmd = shlex.split(cmd) if cmd else []
        self.in_process = set(in_process)
        # what each module called in this process returned (bin.train's
        # Trainer), by module
        self.returned: Dict[str, Any] = {}
        path = os.environ.get("PYTHONPATH", "")
        self.env = dict(os.environ, PYTHONPATH=REPO_ROOT + (
            os.pathsep + path if path else ""))

    def start(self, module: str, args: List[str], log: Optional[str] = None,
              submit: bool = False, gpu: bool = False):
        """Start one job; returns a handle for ``wait``. ``submit`` sends it
        through ``cmd`` (asking for a GPU where ``gpu``), as the shell's
        ``${cmd}`` jobs."""
        if log:
            os.makedirs(os.path.dirname(log) or ".", exist_ok=True)
        if module in self.in_process:
            self.returned[module] = self._call(module, args, log)
            return ("done", module, log, 0)
        argv = [sys.executable, "-m", f"parallelwavegan_torch.bin.{module}",
                *args]
        if self.cmd and submit:
            full = self.cmd + (["--gpu", "1"] if gpu else []) + [log] + argv
            return ("proc", module, log, subprocess.Popen(full, env=self.env))
        out = open(log, "w") if log else None
        try:
            proc = subprocess.Popen(argv, env=self.env, stdout=out,
                                    stderr=subprocess.STDOUT if out else None)
        finally:
            if out:
                out.close()
        return ("proc", module, log, proc)

    @staticmethod
    def _call(module: str, args: List[str], log: Optional[str]) -> Any:
        handler = logging.FileHandler(log) if log else None
        root = logging.getLogger()
        level = root.level
        if handler:
            handler.setFormatter(logging.Formatter(
                "%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
                "%(message)s"))
            root.addHandler(handler)
            root.setLevel(logging.INFO)
        try:
            return importlib.import_module(
                f"parallelwavegan_torch.bin.{module}").main(args)
        finally:
            if handler:
                root.removeHandler(handler)
                root.setLevel(level)
                handler.close()

    @staticmethod
    def wait(handles: list) -> None:
        """Wait for every job; raise naming the logs of those that
        failed."""
        failed = []
        for kind, module, log, job in handles:
            rc = job if kind == "done" else job.wait()
            if rc != 0:
                failed.append(f"{module} (rc {rc}, log {log or 'stdout'})")
        if failed:
            raise RuntimeError("failed: " + "; ".join(failed))

    def run(self, module: str, args: List[str], log: Optional[str] = None,
            submit: bool = False, gpu: bool = False) -> None:
        self.wait([self.start(module, args, log, submit, gpu)])


def shard_scp(scp: str, outdir: str, n: int) -> List[str]:
    """Split a wav.scp round-robin into ``wav.<j>.scp``, j = 1..n (line i,
    counted from 1, to the shard j with j = i mod n, as the shell's awk
    ``NR % n == j % n``)."""
    with open(scp) as f:
        lines = f.readlines()
    paths = []
    for j in range(1, n + 1):
        path = os.path.join(outdir, f"wav.{j}.scp")
        with open(path, "w") as f:
            f.writelines(line for i, line in enumerate(lines, 1)
                         if i % n == j % n)
        paths.append(path)
    return paths


def preprocess_jobs(jobs: Jobs, dumpdir: str, set_name: str, module: str,
                    extra: List[str], conf: str, n_jobs: int) -> list:
    """Start the feature jobs of one set: ``n_jobs`` shards (at most one a
    line) of ``data/<set>/wav.scp``, each logged to
    ``dump/<set>/raw/preprocessing.<j>.log``."""
    rawdir = os.path.join(dumpdir, set_name, "raw")
    os.makedirs(rawdir, exist_ok=True)
    scp = os.path.join("data", set_name, "wav.scp")
    with open(scp) as f:
        n = min(n_jobs, sum(1 for _ in f))
    scps = [scp] if n <= 1 else shard_scp(scp, rawdir, n)
    return [jobs.start(module, ["--wav-scp", s, *extra, "--dumpdir", rawdir,
                                "--config", conf],
                       os.path.join(rawdir, f"preprocessing.{j}.log"),
                       submit=True)
            for j, s in enumerate(scps, 1)]


def write_gt_wavs(rawdir: str, outdir: str, sampling_rate: int) -> int:
    """Stage 4's ground truth: the raw dumps' waves (trimmed and scaled as
    the training targets) as wavs; returns how many."""
    from parallelwavegan_torch.utils.io import read_hdf5, write_wav

    os.makedirs(outdir, exist_ok=True)
    n = 0
    for f in sorted(glob.glob(os.path.join(rawdir, "*.h5"))):
        utt = os.path.splitext(os.path.basename(f))[0]
        write_wav(os.path.join(outdir, utt + ".wav"), read_hdf5(f, "wave"),
                  sampling_rate)
        n += 1
    for f in sorted(glob.glob(os.path.join(rawdir, "*-wave.npy"))):
        utt = os.path.basename(f)[:-len("-wave.npy")]
        write_wav(os.path.join(outdir, utt + ".wav"), np.load(f),
                  sampling_rate)
        n += 1
    return n


def run(conf: str, stage: int = 1, stop_stage: int = 4, tag: str = "",
        n_jobs: int = 4, resume: str = "", pretrain: str = "",
        cmd: Optional[str] = None, device: str = "cuda",
        use_f0: bool = False, token_mode: bool = False,
        skip_normalize: bool = False,
        in_process: Sequence[str] = ()) -> Dict[str, Any]:
    """Stages ``stage``..``stop_stage`` (within 1-4) in the current
    directory. Returns ``expdir``, after stage 3 the ``checkpoint`` it
    decoded, and what the ``in_process`` CLIs returned (``"train"``: the
    Trainer)."""
    from parallelwavegan_torch.utils.io import load_config

    if stop_stage < 1:
        raise ValueError("stages -1 and 0 are the recipe's run.sh "
                         "(download, data_prep); this module runs 1-4")
    stage = max(stage, 1)
    config = load_config(conf)
    tag = tag or os.path.splitext(os.path.basename(conf))[0]
    expdir, dumpdir = os.path.join("exp", tag), "dump"
    local_mode = config.get("use_local_condition") is True
    global_mode = config.get("use_global_condition") is True
    on_card = ["--device", device]
    jobs = Jobs(cmd, in_process)
    out: Dict[str, Any] = {"expdir": expdir}

    if stage <= 1 <= stop_stage:
        print("Stage 1: Feature extraction / statistics / normalization",
              flush=True)
        handles = []
        for set_name in SETS:
            data = os.path.join("data", set_name)
            if token_mode:
                extra = ["--text", os.path.join(data, "text")]
                if os.path.exists(os.path.join(data, "utt2spk")):
                    extra += ["--utt2spk", os.path.join(data, "utt2spk"),
                              "--spk2idx", os.path.join(data, "spk2idx")]
                module = "preprocess_tokens"
            else:
                extra = list(on_card)
                if use_f0:
                    extra.append("--use-f0")
                if local_mode:
                    extra.append("--extract-f0")
                if global_mode and os.path.exists(
                        os.path.join(data, "utt2spk")):
                    extra += ["--utt2spk", os.path.join(data, "utt2spk"),
                              "--spk2idx", os.path.join(data, "spk2idx")]
                module = "preprocess"
            handles += preprocess_jobs(jobs, dumpdir, set_name, module, extra,
                                       conf, n_jobs)
        jobs.wait(handles)
        if token_mode or skip_normalize:
            for set_name in SETS:
                norm = os.path.join(dumpdir, set_name, "norm")
                if os.path.islink(norm) or os.path.isfile(norm):
                    os.remove(norm)
                elif os.path.isdir(norm):
                    shutil.rmtree(norm)
                os.symlink(os.path.abspath(os.path.join(dumpdir, set_name,
                                                        "raw")), norm)
        else:
            ext = "h5" if config.get("format", "hdf5") == "hdf5" else "npy"
            train_raw = os.path.join(dumpdir, "train", "raw")
            stats_dir = os.path.join(dumpdir, "train")
            targets = [("feats", f"stats.{ext}")]
            if local_mode:
                targets.append(("local", f"stats-local.{ext}"))
            jobs.wait([jobs.start("compute_statistics", [
                "--rootdir", train_raw, "--dumpdir", stats_dir,
                "--config", conf, "--target-feats", feats])
                for feats, _ in targets])
            # the local features join the norm dumps that the feats'
            # normalization writes: all sets' feats first, then the local
            for feats, stats in targets:
                jobs.wait([jobs.start("normalize", [
                    "--rootdir", os.path.join(dumpdir, set_name, "raw"),
                    "--dumpdir", os.path.join(dumpdir, set_name, "norm"),
                    "--stats", os.path.join(stats_dir, stats),
                    "--config", conf, "--target-feats", feats,
                    *(["--skip-wav-copy"] if feats == "local" else [])])
                    for set_name in SETS])

    if stage <= 2 <= stop_stage:
        print("Stage 2: Training", flush=True)
        os.makedirs(expdir, exist_ok=True)
        args = ["--train-dumpdir", os.path.join(dumpdir, "train", "norm"),
                "--dev-dumpdir", os.path.join(dumpdir, "dev", "norm"),
                "--outdir", expdir, "--config", conf, *on_card]
        if resume:
            args += ["--resume", resume]
        if pretrain:
            args += ["--pretrain", pretrain]
        jobs.run("train", args, os.path.join(expdir, "train.log"),
                 submit=True, gpu=True)

    if stage <= 3 <= stop_stage:
        print("Stage 3: Decoding", flush=True)
        ckpts = glob.glob(os.path.join(expdir, "checkpoint-*.ckpt"))
        if not ckpts:
            raise FileNotFoundError(f"no checkpoint-*.ckpt in {expdir}")
        out["checkpoint"] = max(ckpts, key=os.path.getmtime)
        jobs.run("decode", ["--dumpdir", os.path.join(dumpdir, "eval", "norm"),
                            "--outdir", os.path.join(expdir, "wav"),
                            "--checkpoint", out["checkpoint"], *on_card])

    if stage <= 4 <= stop_stage:
        print("Stage 4: Objective evaluation", flush=True)
        gt = os.path.join(expdir, "gt_wav")
        write_gt_wavs(os.path.join(dumpdir, "eval", "raw"), gt,
                      config["sampling_rate"])
        scorers = ("evaluate_mcd", "evaluate_f0")
        jobs.wait([jobs.start(name, ["--outdir", os.path.join(expdir, "wav"),
                                     "--gt-wavdir", gt,
                                     "--n-jobs", str(n_jobs)],
                              os.path.join(expdir, f"{name}.log"))
                   for name in scorers])
        for name in scorers:
            with open(os.path.join(expdir, f"{name}.log")) as f:
                print(f.read(), end="", flush=True)
    print("Finished.", flush=True)
    out.update(jobs.returned)
    return out


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(
        description="Run stages 1-4 of a recipe through the port's CLIs, "
        "from the recipe's directory.")
    parser.add_argument("--conf", required=True, type=str)
    parser.add_argument("--stage", default=1, type=int)
    parser.add_argument("--stop-stage", "--stop_stage", default=4, type=int)
    parser.add_argument("--tag", default="", type=str)
    parser.add_argument("--n-jobs", "--n_jobs", default=4, type=int)
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--pretrain", default="", type=str)
    parser.add_argument(
        "--cmd", default=None, type=str,
        help='job wrapper, e.g. "bash ../../common/run_job.sh": each '
        "feature shard and the training run as <cmd> <logfile> <command>")
    parser.add_argument("--use-f0", action="store_true",
                        help="extract f0 at preprocessing (singing corpora)")
    parser.add_argument("--token-mode", action="store_true",
                        help="discrete-token recipe: preprocess_tokens, no "
                        "statistics or normalization")
    parser.add_argument("--skip-normalize", action="store_true",
                        help="train and decode on the raw features")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    return run(args.conf, args.stage, args.stop_stage, args.tag, args.n_jobs,
               args.resume, args.pretrain, args.cmd, args.device, args.use_f0,
               args.token_mode, args.skip_normalize)


if __name__ == "__main__":
    main()
