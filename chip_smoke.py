#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and builds every CUDA
   kernel from csrc/ with nvcc (one process per source, started together);
2. holds each kernel against its plain PyTorch version on the card (f32 and
   bf16, small and real shapes, ragged T, dilations past T): the stack
   forward, the forward with saved inputs, every output of the backward
   (both tensor-core bodies: against its explicit plain version on the
   same saved inputs and, through autograd, against the plain forward),
   the fused MRF stage (f32, bf16 and int8 packs), the matmul bench
   (int32 results bit-equal) and the experiment's variant kernel (bf16
   tanh and bf16 product gate on at most 3 layers, on the tensor-core
   body; int8 taps on the SIMT body);
2h. drives HiFi-GAN v1 serving at full width on the shipped trained
   checkpoint (assets/quality/): (a) f32 exact mode over the 24 evaluation
   mels, the first 8 scored (MCD, log-F0 RMSE, V/UV; host processes that
   run beside the PWG checks of step 3 and are waited for before step 4
   times anything) against the committed per-utterance reference of the
   JAX package; (b) the fused MRF kernel in f32 against
   (a), as many launches as the stages' plans say (mrf_stage_plan: the
   per-conv body, 7 a stage); (c) the kernel with int8 packs against the
   int8 conv chain on the same scales; (d) batch 32 x 512 frames in bf16,
   timed in the exact mode (cuDNN), the int8 conv chain and the kernel in
   both modes (bf16 and int8 packs: the fused-pair body, 4 launches a
   stage), every stage's plan printed and its kernel held against its
   plain version and timed beside it and beside the exact forward's own
   conv chain of that stage (mrf_chain_stage, the median of 5 calls and
   their spread),
   whose four-stage sum must not exceed the exact forward; after the PWG serving path, the
   stage roofline tool, whose run launches the matmul bench kernel, then
   the matmul bench at the five MRF shapes beside torch._int_mm and
   torch.matmul, as back-to-back launches and as CUDA-graph replays
   (device time alone), with the GB/s it reaches;
3. drives the serving path at full PWG v1 width with seeded weights written
   to and read back from a .gckpt: InferenceModel on cuda, (a) batch 1 in
   f32 against the unfused plain generator, (b) batch 32 x 512 frames in
   bf16 and (c) the same batch in f32 (decode's default dtype), each run
   launching the forward kernel as often as its launch plan says (one
   launch per layer: 30; bf16 on the tensor-core body, f32 on the
   split-TF32 body);
4. times the forward, the stack kernel and its plain version in both
   dtypes at that shape with CUDA events, holds the kernel against its
   plain version there, and prints the TFLOP/s reached, the launch plan,
   the bound on the plan's body and the byte floor of one launch per
   layer;
5. drives the training path at full PWG v1 width: a seeded corpus of npy
   dumps, bin.train.run on cuda for 6 steps across the discriminator's
   start (batch 6 x 25,600 samples, f32), whose run must launch the forward
   and the backward kernel the expected number of times, end with finite
   losses under every name, changed G and D parameters and a .ckpt that
   loads back; then two resumed steps with mixed_precision (the backward
   on its bf16 tensor-core body);
6. holds the generator and discriminator loss and every gradient on 5
   batches of the loader, each cut to GATE_BATCH x GATE_SAMPLES
   (gate_window), on the card through the kernels in f32 (k) against the
   CPU through their plain versions in f32 (p) and in float64 (e): per
   parameter |k - e| <= max(2 |p - e|, a), a = 2e-3 of the gradient's
   largest entry + 2e-5 of the largest gradient (tools/float64_check.py),
   with the STFT loss's kinks and the branches of G's ReLUs and D's
   LeakyReLUs decided once, by float64 (gate_gradients, hold_gate, as in
   step 10 (b)), printing the worst gate of each batch; times the (G, adv, D)
   step, both kernels at the training shape (each on the body its launch
   plan names, in f32 both on split-TF32 tensor cores; the forward's x and
   skip and all seven outputs of the backward held against float64, at
   most 2 x the plain version's error) and the backward's plain version,
   then the bf16 backward body (bf16 tensor cores) alone at the same
   shape, held first against its explicit plain version and autograd,
   with its plan, TFLOP/s, bound and the byte floor of what it moves; the
   backward's bound on each body and its two-launch byte floor; and prints
   where the f32 and the mixed-precision step's device time goes
   (torch.profiler);
7. runs the gate and int8 experiment (tools.int8_wavenet_experiment.main)
   at its full shape, 10 layers at batch 32 x 512 frames, whose run launches
   the variant kernel (bf16 taps on the serving stack's tensor-core layer
   body, int8 taps on its SIMT body), prints its four lines, holds each
   variant against its plain version at that shape and the int8 body's
   quantiser bit for bit against the plain quantiser, and prints each variant's body, plan, time, bound and
   per-layer byte floor and the tanh variant's time over the serving
   kernel's;
8. drives HiFi-GAN v1 training at full width with the recipe of the shipped
   checkpoint (assets/quality/config.yml: multi-scale multi-period
   discriminator, mel loss x 45, feature matching, Adam + MultiStepLR, EMA
   0.999) at batch 16 x 8,192 on a seeded corpus: bin.train.run on cuda for
   4 f32 steps, 2 more resumed from the .ckpt with mixed_precision (the
   recipe's setting); finite losses, a moved u, the EMA one decay step from
   the parameters; step time, a profile; then load_model(ckpt,
   use_ema=True) decodes an utterance. Cut: 6 of 60,000 steps, the corpus;
9. serves the MelGAN family at full width from reference .pkl files that
   the port's exporter writes from seeded weights: (a) multi-band MelGAN
   v2 (egs/ljspeech/voc1/conf/multi_band_melgan.v2.yaml: PQMF on the old
   prototype) through load_model on cuda; (b) f32 at batch 2 x 200 frames
   held to the CPU's float64 forward (at most 2 x the CPU f32 forward's
   error + 1e-6); (c) bf16 at batch 32 x 512 frames against f32 on the
   card; (d) both timed there, with one torch.profiler pass each; (e)
   full-band MelGAN v1 at batch 1 against its CPU forward; (f) the shipped
   HiFi-GAN checkpoint exported to a .pkl and decoded by bin.decode from a
   Kaldi ark and an npy feats.scp, bit-equal to the .gckpt route on all 24
   mels; (g) the asset's mels end to end as one utterance through
   inference_chunked (chunk 256, context 64) against the whole forward:
   HiFi-GAN exact and on mrf_stage with f32 packs (both to f32
   tolerances), on mrf_stage with bf16 packs (to the bf16 tolerance: the
   cuDNN convs around the kernel round a window otherwise than the whole;
   the kernel itself on one window's stage-0 input must give the whole's
   rows bit for bit), multi-band MelGAN, and PWG v1 on wavenet_stack
   window by window on its noise; the chunked runs' kernel launches
   counted, wall times beside the whole's;
10. trains the MelGAN family and Parallel WaveGAN v3 at full width: (a)
   multi-band MelGAN v2 with its recipe
   (egs/ljspeech/voc1/conf/multi_band_melgan.v2.yaml: the multi-scale
   MelGAN discriminator, the subband STFT loss, lambda_adv 2.5, Adam +
   MultiStepLR; chip_smoke.MB_MELGAN_V2_TRAIN, held to the yaml by a CPU
   test) at batch 64 x 16,384 from a seeded wav.scp + feats.scp:
   bin.train.run on cuda, 4 f32 steps (the discriminator from step 2), 2
   more resumed from the .ckpt with mixed_precision; finite losses under
   every name, the subband terms included, moved G and D parameters, a
   .ckpt that loads back; step times and a profile of each precision; (b)
   on the loader's batch cut to 2 x 16,384 the generator and the
   discriminator loss and every gradient on the card in f32 (k), on the
   CPU in f32 (p) and in float64 (e), each gradient held to
   |k - e| <= max(2 |p - e|, a) (no hand-written kernel: this holds cuDNN
   and the port's modules): G's outputs (float64_gate), G's own
   gradients (each route's e float64's gradient at that route's own
   outputs), the loss's cotangents at G's outputs (its backward through D
   alone), G's gradients on float64's cotangents (the network's backward
   alone) and D's gradients, the loss's kinks and the branches of G's and
   D's LeakyReLUs (and G's ReLUs) decided by float64 (gate_gradients,
   hold_gate), then the
   pooling's
   input gradient on the card against float64 beside F.avg_pool1d's
   (check_pooling_backward); (c) Parallel WaveGAN v3
   (parallel_wavegan.v3.yaml: kernel size 5, the multi-scale MelGAN
   discriminator with feature matching) at batch 16 x 8,192, 3 f32 steps
   with the discriminator from step 1, on the per-layer path: kernel size
   5 lies outside the fused stack (the JAX step's too), so the step
   refuses the fused path and neither stack kernel launches (counted);
   (d) the generator of (a)'s last .ckpt through save_generator_checkpoint
   and load_model with PQMF on cuda against the CPU at 1 x 200 frames,
   printing the PQMF prototypes training and serving chose;
11. prints a JSON line of the five kernels, the card line, and as the last
   line {"ok": true, "device": {...}}, after steps 12 to 19;
12. serves and trains StyleMelGAN v1 at full width
   (egs/ljspeech/voc1/conf/style_melgan.v1.yaml: the TADE generator on a
   noise grid of 88 frames, the random-window discriminator with PQMF at
   1, 2, 4 and 8 subbands; no hand-written kernel, in the JAX package as
   here): (a) seeded weights written to a reference .pkl by the port's
   exporter and read back by load_model on cuda; (b) f32 at batch 2 x 200
   frames (3 noise frames) held to the CPU's float64 forward on the same z
   (at most 2 x the CPU f32 forward's error + 1e-6); (c) bf16 against f32
   at batch 32 x 512 frames on the same z, within 2e-2 (1 + max), both
   timed with CUDA events and profiled once; (d) the asset's 24 mels as
   one 7,200-frame utterance through inference_chunked (chunk 256 and
   context 64, rounded to the grid: 264 and 88) on the card in f32 against
   the CPU port's chunks on the same noise within 1e-5 (1 + max), the
   chunked-vs-whole difference and both wall times printed; (e) training
   with the recipe (chip_smoke.STYLE_MELGAN_V1_TRAIN, held to the yaml by
   a CPU test) at batch 32 x 22,528 from a seeded npy corpus:
   bin.train.run on cuda, 3 f32 steps with the discriminator from step 1,
   2 more resumed from the .ckpt with mixed_precision; finite losses under
   every name, moved G and D parameters, a .ckpt that loads back; step
   times, a profile of each precision, the peak memory; (f) on the
   loader's batch cut to 2 x 22,528, with fixed noise and window starts,
   every G and D gradient on the card in f32 (k) and on the CPU in f32 (p)
   and float64 (e), held to |k - e| <= max(2 |p - e|, a)
   (tools/float64_check.gradient_gate), as in step 10 (b); (g) the
   launches of the five
   kernels counted over (a)-(f): 0. The CPU routes of (b), (d) and (f) are
   the references, labelled as such;
13. serves and trains the VQ-VAE at full width
   (egs/vctk/vq1/conf/conditioned_melgan_vae.v3.yaml: the MelGAN
   discriminator tower as encoder, 64 x down to 256 dims, a codebook of
   512 x 256, 128 speakers, a MelGAN decoder; no hand-written kernel, in
   the JAX package as here): (a) seeded weights (the codebook rows
   latents of a seeded batch) written to a reference .pkl by the port's
   exporter and read back by load_model on cuda; (b) 8 seeded utterances
   of 1-6 s at 24 kHz (one of a ragged length) with speaker ids through
   vq_encode -> vq_decode on the card against the CPU port: the codes
   equal but at near-ties (a float64 gap between a latent's two nearest
   distances below 1e-5 (||z||^2 + max ||e||^2)), counted, the waves from
   the same codes within 1e-4 (1 + max), the distinct codes and the
   batch-1 wall printed; (c) decode(encode(x)) in f32 at 32 x 131,072
   samples timed with CUDA events, with its FLOP count, bound, a profile
   and the peak memory; (d) bin.decode on the card over npy dumps of the
   unconditioned cut (decoder input 256), its text the codes vq_encode
   gives; (e) training with the recipe (chip_smoke.VQVAE_V3_TRAIN, held to
   the yaml by a CPU test; windows at hop 64, VQVAE_V3_HOP_CUT, since the
   recipe's hop 300 cuts them to 8,100 samples, which neither package's
   step takes) at batch 16 x 8,192 from a seeded npy corpus of 16
   utterances of 4 speakers: bin.train.run on cuda, 3 f32 steps with the
   discriminator from step 1 and the dead-code restart, 2 more resumed from
   the .ckpt with mixed_precision; finite losses under every name and
   vq_codes_used, moved encoder, decoder, D and codebook, a .ckpt that
   loads back; step
   times, a profile of each precision, the peak memory; (f) one f32 step of
   the local recipe (local_conditioned_melgan_vae.v3.yaml: a 2-channel
   -local.npy at hop 64); (g) on the loader's batch cut to 2 x 8,192,
   through the trained G with (a)'s seeded encoder and codebook
   (separated codes) and the trained D, every G and D gradient on the card in f32 (k) and on the
   CPU in f32 (p) and float64 (e), the codes of k and p first held to e's
   by the near-tie rule (at most 1 % of them may differ), then all three
   on e's codes (the model's explicit indices), held to
   |k - e| <= max(2 |p - e|, a) as in step 10 (b); (h) the launches of
   the five kernels
   counted over (a)-(g): 0;
14. serves and trains UHiFiGAN at full width
   (egs/opencpop/voc1/conf/uhifigan.v1.yaml: the sine-excitation U-Net of
   32 channels rising to 512, 25.6 M parameters, dropout 0.1; the
   multi-scale multi-period discriminator; no hand-written kernel, in the
   JAX package as here): (a) seeded weights written to a reference .pkl by
   the port's exporter and read back by load_model on cuda; 8 utterances
   of 40-115 frames with seeded f0 contours and their excitations (the
   port's sine_excitation) through InferenceModel.inference(c, f0=,
   excitation=), card f32 within 1e-4 (1 + max) and bf16 within 2e-2 of
   the CPU port's f32; (b) 32 x 512 frames (204.8 s of audio) through the
   generator in f32 and bf16, timed with CUDA events, with its FLOP count,
   bound, a profile and the peak memory; (c) bin.decode on the card over
   seeded -feats/-f0/-excitation.npy dumps, each wave frames x 300
   samples; (d) training with the recipe (chip_smoke.UHIFIGAN_V1_TRAIN,
   held to the yaml by a CPU test) at batch 16 x 8,400 from a seeded npy
   corpus of 16 utterances: bin.train.run on cuda, 3 f32 steps (the
   recipe's gates: D from step 1, G from step 2), 2 more resumed from the
   .ckpt with mixed_precision; finite losses under every name, moved G
   and D parameters, a .ckpt that loads back; step times, a profile of
   each precision, the peak memory; the dropout masks of a step drawn on
   the host and copied against drawn on the card, timed; (e) on the
   loader's batch cut to 1 x 4,200 (UHIFIGAN_GATE_SAMPLES, cut from 8,400
   to make room for step 16), with one set of dropout masks handed
   to every route and D in eval mode, every G and D gradient on the card
   in f32 (k) and on the CPU in f32 (p) and float64 (e), the kinks of the
   STFT loss, the mel loss (kinked_mel: its power and mel clamps and its
   L1 signs) and feature matching decided by float64, held to
   |k - e| <= max(2 |p - e|, a) as in step 10 (b); (f) the launches of the
   five kernels counted over (a)-(e): 0. Step 10 (b) also holds the
   HiFi-GAN multi-scale discriminator's pooling (kernel 4, stride 2,
   padding 2, count_include_pad True) as it holds the MelGAN one's;
15. serves and trains the discrete-symbol families at the full width of
   their recipes (chip_smoke.DISCRETE_RECIPES, held to the yaml by a CPU
   test: the token HiFi-GAN of egs/vctk/hubert_voc1/conf/hifigan_hubert.
   v1.yaml, 100 units and 128 speakers; the duration generator of
   egs/opencpop/token_voc1/conf/hifigan_token_16k_duration.v1.yaml, 1,024
   tokens, a predictor of 2 x 384 with dropout 0.5, max_reg_len 2,048; the
   F0 generator of hifigan_token_24k_nodp_f0.v1.yaml; the token
   StyleMelGAN of egs/vctk/hubert_voc1/conf/style_melgan_hubert.v1.yaml; no
   hand-written kernel, in the JAX package as here): (a) seeded weights
   written to a reference .pkl by the port's exporter and read back by
   load_model on cuda; 8 utterances of 40-115 tokens, ids over the whole
   vocabulary (above 256 too), a speaker id or an f0 contour as the
   family needs, card f32 within 1e-4 (1 + max) and bf16 within 2e-2 of
   the CPU port's f32 (the duration model's CPU reference at max_reg_len
   512, DURATION_CPU_REG_LEN); the duration generator's predicted
   durations card vs CPU (a flip allowed only within 1e-4 of a rounding tie in float64,
   on at most 1 % of the tokens), every wave held to the CPU's f32 wave
   teacher-forced on the integer durations its route regulated by (bf16
   rounds them in bf16), 8 of each dtype, each sum(ds) x 320 samples; (b) 32 x 512 tokens through the token generator
   in f32 and bf16, timed with CUDA events, with its FLOP count, bound, a
   profile and the peak memory, and the duration generator's batch-1
   wall (its 2,048-frame trunk forward) and audio-s/s on the cut output;
   (c) bin.decode on the card over seeded token dumps (the F0 recipe's
   -f0.npy read by default) and bin.decode_from_text with --unique (and
   --spk-idx for the token model), every wave of its expected length;
   (d) training the duration recipe at 16 x 10,240 from a seeded npy
   corpus of 16 utterances whose tokens come in runs: bin.train.run on
   cuda, 3 f32 steps under the recipe's gates, 2 more resumed from the
   .ckpt with mixed_precision; finite losses under every name
   (duration_loss included), moved G (the token table and the predictor
   among them) and D, a .ckpt that loads back; step times, a profile of
   each precision, the peak memory, the predictor's dropout masks drawn
   on the card; then 3 f32 steps (the last G and D) of the token, F0 and
   token StyleMelGAN recipes at their full batch, StyleMelGAN's D from
   step 1; (e) on the duration batch cut to 1 x 10,240, with one set of
   dropout masks handed to every route and D in eval mode, every G and D
   gradient on the card in f32 (k) and on the CPU in f32 (p) and float64
   (e), the mel loss's and feature matching's kinks and the branches of
   G's LeakyReLUs and ReLUs (the predictor's) and D's LeakyReLUs decided
   by float64, the duration term's cotangent included, held to
   |k - e| <= max(2 |p - e|, a) (the first gate through F.embedding's
   CUDA backward, a scatter-add); (f) the launches of the five kernels
   counted over (a)-(e): 0;
16. trains data-parallel through the port's launcher
   (parallelwavegan_torch.distributed.launch, which starts this script
   again as ``chip_smoke.py --dp-worker DIR`` on every rank; two launches
   started together, one of two ranks on this one card, so through gloo,
   for (a), (c) and (d), one of one rank through NCCL for (b)): (a) two
   ranks train PWG v1 at the
   training path's 6 x 25,600 samples (3 a rank from the per-rank loader
   of step 5's corpus), f32, three (G, adv, D) steps from one seeded state
   through the stack kernels, each rank counting its launches of both
   (added to the kernels line as data_parallel_launches); after every
   step every rank's parameters, buffers and optimizer moments are bit-equal
   to rank 0's, and after the last the state is bit-equal to a one-process
   emulation (tools/dp_emulation: the ranks as threads, the two
   half-batches' gradients averaged in memory) on the ranks' batches, with
   cuDNN deterministic in both; (b) one rank through NCCL on the whole
   batch, bit-equal to the plain single-process step on its batches; (c)
   StyleMelGAN v1 on two ranks given the same example (1 x 22,528 a rank,
   two steps, cut from 32 x 22,528): the noise and the discriminator's
   windows differ across the ranks, the replicas stay bit-equal, and a
   rerun draws and trains bit for bit the same; (d) the VQ-VAE of step 13
   with restarts on two ranks of one example each (1 x 8,192, two steps,
   cut from 16 x 8,192): the codebook, restarted from the ranks' mean rows
   where no rank's latent chose a code, is bit-equal on both ranks. Each
   launch's and check's wall time is printed;
17. runs a recipe on the card through the port's stage runner
   (bin/run_stages.py) from the files users run, with neither PyYAML nor
   h5py (utils/yaml_lite.py, utils/hdf5_lite.py): (a) reads every
   egs/**/conf/*.yaml and assets/quality/config.yml; (b) in a recipe
   directory whose data/{train,dev,eval}/wav.scp hold the 24 shipped
   ground-truth wavs (20 train, the last RECIPE_DEV as dev and eval), its
   stage 1 with egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml
   (its step counts and intervals cut, RECIPE_CUT, written by yaml_lite;
   hdf5 dumps, the log-mel on the card in float64; RECIPE_JOBS feature jobs
   a set, all started together), against bin.preprocess with --device cpu
   (feats within RECIPE_FEATS_TOL, waves bit-equal, len(wave) == len(feats)
   x hop on every file), its statistics and normalization standardizing
   the train feats; (c) its stage 2, bin.train in this process: 3
   steps at 6 x 25,600 in f32 (G steps: step 0 trains nothing, the
   discriminator starts at 100,000) through B1 and B2, both counted from 0
   around the stage and above 0, G's parameters moved, the config.yml it
   writes loads back equal, exp/<tag>/train.log written; (d) its stage
   3, bin.decode of the eval dumps with the newest checkpoint in this
   process on B1 (counted), and its stage 4, the ground truth from the raw
   dumps and bin.evaluate_mcd and bin.evaluate_f0 in RECIPE_JOBS processes
   each (printed, not gated); (e) bin.convert_checkpoint takes the trained
   .ckpt to a .pkl, back to a .ckpt and to a .pkl again, bit-equal to the
   first, and bin.decode serves step 13's conditioned VQ-VAE (.pkl, yaml
   config) from an hdf5 dump with its speaker id, equal to
   vq_decode(vq_encode(x), g);
18. (a) the stage runner's stage 1 of an npy copy of the same recipe
   (format: npy; one feature job a set); (b) bin.train.run on its dumps, 3
   steps at 6 x 25,600 each: on the native C++ loader (use_native_loader
   auto, asserted to be the loader used; B1 and B2 counted around the run)
   with the profiler hook on steps 1 and 2 (profile_dir, NATIVE_PROFILE),
   again unprofiled (the profiler's start takes seconds of step 1), and on
   the PyTorch loader (use_native_loader: false), printing for each run how
   long each batch kept the loop waiting and the wall from batch to batch,
   beside the card's name and power limit; (c) rank 0's trace file
   (rank0-steps1-2.pt.trace.json) exists and names B1's and B2's kernels;
   (d) the shipped HiFi-GAN v1 (assets/quality/) exported by
   utils/export.export_generator at 1 x EXPORT_FRAMES frames on the card
   and loaded back: the program's wave within EXPORT_TOL (1 + max) of
   InferenceModel's module forward on the same mel, both timed;
19. the op census (parallelwavegan_torch/tools/op_census.py): one f32
   (G, adv, D) step of each of CENSUS_RECIPES (PWG v1, HiFi-GAN v1,
   MB-MelGAN v2, PWG v3, StyleMelGAN v1, the VQ-VAE, UHiFiGAN, the
   duration token HiFi-GAN) at its width and batch under a
   TorchDispatchMode that records every distinct aten call, forward and
   backward, but the pointwise ones, copies, views, factories and draws;
   each key replayed on the card in f32, on the CPU in f32 and in
   float64 (the CPU routes on the process pool of step 2h), the tensors
   derived from the batch cut to batch 2 and time max(2,048, 4 receptive
   fields) with the recorded layout, and once at its recorded shape on
   the card (every output that depends on the first batch element alone
   held there too); per key and output the card's error from float64 at
   most 2 x the CPU f32 error + 1e-6 (of 1 + max) or counted past that
   rule; one line per op kind (keys, worst card-over-CPU factor, worst
   error, their recipes) and a total; raises on a key past 1e-4 (of 1 +
   max). op_census_on_card.py beside this script runs the step alone.

Exits non-zero, printing no result, on any failure or without a GPU.
"""

from __future__ import annotations

import copy
import glob
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

# published dense peaks of an H100 SXM at 700 W (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
HOP, SR, BENCH_BATCH, BENCH_FRAMES = 256, 22050, 32, 512
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # x (1 + max|plain|)

TRAIN_BATCH, TRAIN_SAMPLES = 6, 25600

# Parallel WaveGAN v1 (egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml)
PWG_V1 = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "num_mels": 80,
    "format": "npy",
    "generator_type": "ParallelWaveGANGenerator",
    "generator_params": {
        "in_channels": 1, "out_channels": 1, "kernel_size": 3, "layers": 30,
        "stacks": 3, "residual_channels": 64, "gate_channels": 128,
        "skip_channels": 64, "aux_channels": 80, "aux_context_window": 2,
        "dropout": 0.0, "use_weight_norm": True,
        "upsample_net": "ConvInUpsampleNetwork",
        "upsample_params": {"upsample_scales": [4, 4, 4, 4]},
    },
    "discriminator_type": "ParallelWaveGANDiscriminator",
    "discriminator_params": {
        "in_channels": 1, "out_channels": 1, "kernel_size": 3, "layers": 10,
        "conv_channels": 64, "bias": True, "use_weight_norm": True,
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.2},
    },
    "stft_loss_params": {
        "fft_sizes": [1024, 2048, 512], "hop_sizes": [120, 240, 50],
        "win_lengths": [600, 1200, 240], "window": "hann_window",
    },
    "lambda_adv": 4.0,
    "batch_size": TRAIN_BATCH,
    "batch_max_steps": TRAIN_SAMPLES,
    "remove_short_samples": True,
    "allow_cache": True,
    "generator_optimizer_params": {"lr": 1e-4, "eps": 1e-6,
                                   "weight_decay": 0.0},
    "generator_scheduler_params": {"step_size": 200000, "gamma": 0.5},
    "generator_grad_norm": 10,
    "discriminator_optimizer_params": {"lr": 5e-5, "eps": 1e-6,
                                       "weight_decay": 0.0},
    "discriminator_scheduler_params": {"step_size": 200000, "gamma": 0.5},
    "discriminator_grad_norm": 1,
    # the yaml trains 400,000 steps with the discriminator from 100,000;
    # cut so that six steps cross the discriminator's start
    "discriminator_train_start_steps": 2,
    "train_max_steps": 6,
    "save_interval_steps": 6,
    "eval_interval_steps": 6,
    "log_interval_steps": 3,
}
# HiFi-GAN v1 as trained for the shipped checkpoint
# (assets/quality/config.yml; a CPU test holds this dict to that file)
REPO = os.path.dirname(os.path.abspath(__file__))
ASSET_DIR = os.path.join(REPO, "assets", "quality")
QUALITY_REFERENCE = os.path.join(
    REPO, "tests", "data", "torch_hifigan_quality_reference.json")
HIFIGAN_V1 = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "num_mels": 80,
    "generator_type": "HiFiGANGenerator",
    "generator_params": {
        "in_channels": 80, "out_channels": 1, "channels": 512,
        "kernel_size": 7, "upsample_scales": [8, 8, 2, 2],
        "upsample_kernel_sizes": [16, 16, 4, 4],
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        "use_additional_convs": True, "bias": True,
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.1},
        "use_weight_norm": True,
    },
}
# the MelGAN family at full width with seeded weights, served from a
# reference .pkl (CPU tests hold these generator settings to the files):
# multi-band MelGAN v2 (egs/ljspeech/voc1/conf/multi_band_melgan.v2.yaml; no
# "version" and no pqmf_params, so PQMF takes the <= 0.4.2 prototype: taps
# 62, cutoff 0.15, beta 9.0) and full-band MelGAN v1 (melgan.v1.yaml)
MB_MELGAN_V2 = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "num_mels": 80,
    "generator_type": "MelGANGenerator",
    "generator_params": {
        "in_channels": 80, "out_channels": 4, "kernel_size": 7,
        "channels": 384, "upsample_scales": [8, 4, 2],
        "stack_kernel_size": 3, "stacks": 4, "use_weight_norm": True,
        "use_causal_conv": False,
    },
}
MELGAN_V1 = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "num_mels": 80,
    "generator_type": "MelGANGenerator",
    "generator_params": {
        "in_channels": 80, "out_channels": 1, "kernel_size": 7,
        "channels": 512, "upsample_scales": [8, 8, 2, 2],
        "stack_kernel_size": 3, "stacks": 3, "use_weight_norm": True,
        "use_causal_conv": False,
    },
}
# the recipe that trained the shipped checkpoint (same file; held to it by
# the same CPU test), on a seeded npy corpus; the file trains 60,000 steps
HIFIGAN_V1_TRAIN = dict(
    HIFIGAN_V1,
    format="npy",
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params={
        "scales": 3,
        "scale_downsample_pooling": "AvgPool1d",
        "scale_downsample_pooling_params": {
            "kernel_size": 4, "stride": 2, "padding": 2},
        "scale_discriminator_params": {
            "in_channels": 1, "out_channels": 1,
            "kernel_sizes": [15, 41, 5, 3], "channels": 128,
            "max_downsample_channels": 1024, "max_groups": 16, "bias": True,
            "downsample_scales": [2, 2, 4, 4, 1],
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.1},
        },
        "follow_official_norm": True,
        "periods": [2, 3, 5, 7, 11],
        "period_discriminator_params": {
            "in_channels": 1, "out_channels": 1, "kernel_sizes": [5, 3],
            "channels": 32, "downsample_scales": [3, 3, 3, 3, 1],
            "max_downsample_channels": 1024, "bias": True,
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.1},
            "use_weight_norm": True, "use_spectral_norm": False,
        },
    },
    use_stft_loss=False,
    use_mel_loss=True,
    mel_loss_params={
        "fs": SR, "fft_size": 1024, "hop_size": HOP, "win_length": None,
        "window": "hann", "num_mels": 80, "fmin": 0, "fmax": 11025,
        "log_base": None,
    },
    use_feat_match_loss=True,
    feat_match_loss_params={
        "average_by_discriminators": False, "average_by_layers": False,
        "include_final_outputs": False,
    },
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0,
    batch_size=16, batch_max_steps=8192,
    remove_short_samples=False, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params={"lr": 2e-4, "betas": [0.5, 0.9],
                                "weight_decay": 0.0},
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params={"gamma": 0.5,
                                "milestones": [12000, 22000, 37000]},
    generator_grad_norm=-1,
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params={"lr": 2e-4, "betas": [0.5, 0.9],
                                    "weight_decay": 0.0},
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params={"gamma": 0.5,
                                    "milestones": [12000, 22000, 37000]},
    discriminator_grad_norm=-1,
    generator_ema_decay=0.999,
    mixed_precision=True,
    fuse_real_fake_discriminator=False,
    generator_train_start_steps=1,
    discriminator_train_start_steps=0,
)
# what this script sets itself: four steps, one evaluation, one checkpoint
HIFIGAN_V1_TRAIN_CUT = dict(train_max_steps=4, save_interval_steps=4,
                            eval_interval_steps=4, log_interval_steps=2)
HIFIGAN_LOSS_NAMES = (
    "mel_loss", "adversarial_loss", "feature_matching_loss",
    "generator_loss", "real_loss", "fake_loss", "discriminator_loss",
)
# multi-band MelGAN v2 as its recipe trains it
# (egs/ljspeech/voc1/conf/multi_band_melgan.v2.yaml; a CPU test holds every
# key to the file), read from a seeded wav.scp + feats.scp
MB_MELGAN_V2_TRAIN = dict(
    MB_MELGAN_V2,
    format="hdf5",
    discriminator_type="MelGANMultiScaleDiscriminator",
    discriminator_params={
        "in_channels": 1, "out_channels": 1, "scales": 3,
        "downsample_pooling": "AvgPool1d",
        "downsample_pooling_params": {
            "kernel_size": 4, "stride": 2, "padding": 1,
            "count_include_pad": False},
        "kernel_sizes": [5, 3], "channels": 16,
        "max_downsample_channels": 512, "bias": True,
        "downsample_scales": [4, 4, 4],
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.2},
    },
    stft_loss_params=PWG_V1["stft_loss_params"],
    use_subband_stft_loss=True,
    subband_stft_loss_params={
        "fft_sizes": [384, 683, 171], "hop_sizes": [30, 60, 10],
        "win_lengths": [150, 300, 60], "window": "hann_window"},
    use_feat_match_loss=False,
    lambda_adv=2.5,
    batch_size=64, batch_max_steps=16384,
    remove_short_samples=True, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params={"lr": 0.001, "eps": 1.0e-07,
                                "weight_decay": 0.0},
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params={
        "gamma": 0.5, "milestones": [100000, 200000, 300000, 400000]},
    generator_grad_norm=-1,
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params={"lr": 0.001, "eps": 1.0e-07,
                                    "weight_decay": 0.0},
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params={
        "gamma": 0.5, "milestones": [100000, 200000, 300000, 400000]},
    discriminator_grad_norm=-1,
)
# what this script sets itself: four steps (the discriminator from step 2,
# not 200,000), one evaluation, one checkpoint
MB_MELGAN_V2_TRAIN_CUT = dict(
    discriminator_train_start_steps=2, train_max_steps=4,
    save_interval_steps=4, eval_interval_steps=4, log_interval_steps=2)
MB_MELGAN_LOSS_NAMES = (
    "spectral_convergence_loss", "log_stft_magnitude_loss",
    "sub_spectral_convergence_loss", "sub_log_stft_magnitude_loss",
    "adversarial_loss", "generator_loss", "real_loss", "fake_loss",
    "discriminator_loss",
)
# Parallel WaveGAN v3 (egs/ljspeech/voc1/conf/parallel_wavegan.v3.yaml; a
# CPU test holds every key to the file but the data format, a seeded npy
# corpus): v1's generator with kernel size 5, the multi-scale MelGAN
# discriminator, feature matching x 25. Kernel size 5 lies outside the
# fused WaveNet stack (the JAX step runs its per-layer path there too);
# the port's CUDA step refuses to fall back, so the per-layer path is asked
# for by name
PWG_V3_TRAIN = dict(
    PWG_V1,
    generator_params=dict(PWG_V1["generator_params"], kernel_size=5),
    discriminator_type="MelGANMultiScaleDiscriminator",
    discriminator_params={
        "in_channels": 1, "out_channels": 1, "scales": 3,
        "downsample_pooling": "AvgPool1d",
        "downsample_pooling_params": {
            "kernel_size": 4, "stride": 2, "padding": 1,
            "count_include_pad": False},
        "kernel_sizes": [5, 3], "channels": 16,
        "max_downsample_channels": 1024, "downsample_scales": [4, 4, 4, 4],
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.2},
        "use_weight_norm": True,
    },
    lambda_adv=4.0, use_feat_match_loss=True, lambda_feat_match=25.0,
    batch_size=16, batch_max_steps=8192,
    generator_scheduler_params={"step_size": 3000000, "gamma": 0.5},
    discriminator_scheduler_params={"step_size": 3000000, "gamma": 0.5},
)
for _key in ("discriminator_train_start_steps", "train_max_steps",
             "save_interval_steps", "eval_interval_steps",
             "log_interval_steps"):
    del PWG_V3_TRAIN[_key]
# three steps (step 0 trains nothing: the gates are strict), the
# discriminator from step 1 (not 100,000), one evaluation, one checkpoint
PWG_V3_TRAIN_CUT = dict(
    fused_wavenet=False, discriminator_train_start_steps=0,
    train_max_steps=3, save_interval_steps=3, eval_interval_steps=3,
    log_interval_steps=1)
# StyleMelGAN v1 (egs/ljspeech/voc1/conf/style_melgan.v1.yaml; a CPU test
# holds every key to the file but the data format, a seeded npy corpus)
STYLE_MELGAN_V1 = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "num_mels": 80,
    "generator_type": "StyleMelGANGenerator",
    "generator_params": {
        "in_channels": 128, "aux_channels": 80, "channels": 64,
        "out_channels": 1, "kernel_size": 9, "dilation": 2, "bias": True,
        "noise_upsample_scales": [11, 2, 2, 2],
        "noise_upsample_activation": "LeakyReLU",
        "noise_upsample_activation_params": {"negative_slope": 0.2},
        "upsample_scales": [2, 2, 2, 2, 2, 2, 2, 2, 1],
        "upsample_mode": "nearest", "gated_function": "softmax",
        "use_weight_norm": True,
    },
}
STYLE_MELGAN_V1_TRAIN = dict(
    STYLE_MELGAN_V1,
    format="npy",
    discriminator_type="StyleMelGANDiscriminator",
    discriminator_params={
        "repeats": 2, "window_sizes": [512, 1024, 2048, 4096],
        "pqmf_params": [[1, None, None, None], [2, 62, 0.267, 9.0],
                        [4, 62, 0.142, 9.0], [8, 62, 0.07949, 9.0]],
        "discriminator_params": {
            "out_channels": 1, "kernel_sizes": [5, 3], "channels": 16,
            "max_downsample_channels": 512, "bias": True,
            "downsample_scales": [4, 4, 4, 1],
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.2},
            "pad": "ReflectionPad1d", "pad_params": {},
        },
        "use_weight_norm": True,
    },
    stft_loss_params=PWG_V1["stft_loss_params"],
    lambda_aux=1.0,
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    lambda_adv=1.0,
    batch_size=32, batch_max_steps=22528,
    remove_short_samples=False, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params={"lr": 0.0001, "betas": [0.5, 0.9],
                                "weight_decay": 0.0},
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params={
        "gamma": 0.5,
        "milestones": [100000, 300000, 500000, 700000, 900000]},
    generator_grad_norm=-1,
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params={"lr": 0.0002, "betas": [0.5, 0.9],
                                    "weight_decay": 0.0},
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params={
        "gamma": 0.5, "milestones": [200000, 400000, 600000, 800000]},
    discriminator_grad_norm=-1,
    generator_train_start_steps=0,
)
# three steps (step 0 trains nothing: the gates are strict), the
# discriminator from step 1 (not 100,000), one evaluation, one checkpoint
STYLE_MELGAN_V1_TRAIN_CUT = dict(
    discriminator_train_start_steps=0, train_max_steps=3,
    save_interval_steps=3, eval_interval_steps=3, log_interval_steps=1)
# the globally conditioned MelGAN VQ-VAE for VCTK
# (egs/vctk/vq1/conf/conditioned_melgan_vae.v3.yaml; a CPU test holds every
# key to the file but the data format, a seeded npy corpus): the MelGAN
# discriminator tower as encoder (64 x down to 256 dims), a codebook of
# 512 x 256, 128 speakers of 128 dims, a MelGAN decoder of 384 inputs
VQ_SR = 24000
VQVAE_V3 = {
    "sampling_rate": VQ_SR,
    "hop_size": 300,
    "use_global_condition": True,
    "generator_type": "VQVAE",
    "generator_params": {
        "in_channels": 1, "out_channels": 1, "num_embeds": 512,
        "embed_dim": 256, "num_global_embeds": 128, "global_embed_dim": 128,
        "encoder_type": "MelGANDiscriminator",
        "encoder_conf": {"out_channels": 256,
                         "downsample_scales": [4, 4, 2, 2],
                         "max_downsample_channels": 1024},
        "decoder_type": "MelGANGenerator",
        "decoder_conf": {"in_channels": 384, "upsample_scales": [4, 4, 2, 2],
                         "channels": 512, "stacks": 3},
    },
}
VQVAE_V3_TRAIN = dict(
    VQVAE_V3,
    format="npy",
    discriminator_type="MelGANMultiScaleDiscriminator",
    discriminator_params={
        "in_channels": 1, "out_channels": 1, "scales": 3,
        "downsample_pooling": "AvgPool1d",
        "downsample_pooling_params": {"kernel_size": 4, "stride": 2,
                                      "padding": 1,
                                      "count_include_pad": False},
        "kernel_sizes": [5, 3], "channels": 16,
        "max_downsample_channels": 1024, "downsample_scales": [4, 4, 4, 4],
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.2},
        "use_weight_norm": True,
    },
    stft_loss_params={"fft_sizes": [1024, 2048, 512],
                      "hop_sizes": [120, 240, 50],
                      "win_lengths": [600, 1200, 240],
                      "window": "hann_window"},
    use_feat_match_loss=True, lambda_commit=0.25, lambda_feat_match=25.0,
    lambda_adv=4.0, batch_size=16, batch_max_steps=8192,
    remove_short_samples=False, allow_cache=False,
    generator_optimizer_params={"lr": 0.0001, "eps": 1.0e-06,
                                "weight_decay": 0.0},
    generator_scheduler_params={"step_size": 200000, "gamma": 0.5},
    generator_grad_norm=10,
    discriminator_optimizer_params={"lr": 5.0e-05, "eps": 1.0e-06,
                                    "weight_decay": 0.0},
    discriminator_scheduler_params={"step_size": 200000, "gamma": 0.5},
    discriminator_grad_norm=1,
)
del VQVAE_V3_TRAIN["hop_size"]  # cut: VQVAE_V3_HOP_CUT
# the same with a 2-channel local condition (log-f0 and V/UV) at hop 64
# through a 1x1 conv to 32 dims (local_conditioned_melgan_vae.v3.yaml)
VQVAE_LOCAL_V3_TRAIN = dict(
    VQVAE_V3_TRAIN, hop_size=64, use_local_condition=True,
    generator_params=dict(
        VQVAE_V3["generator_params"], num_local_embeds=2,
        local_embed_dim=32,
        decoder_conf=dict(VQVAE_V3["generator_params"]["decoder_conf"],
                          in_channels=416)))
# three steps (step 0 trains nothing: the gates are strict), the
# discriminator from step 1 (not 100,000), one evaluation, one checkpoint,
# and the dead-code restart (egs/synthetic/voc1/conf/vqvae.v1.rich.yaml
# sets it; the VCTK recipes leave it off)
VQVAE_V3_TRAIN_CUT = dict(
    discriminator_train_start_steps=0, train_max_steps=3,
    save_interval_steps=3, eval_interval_steps=3, log_interval_steps=1,
    vq_dead_code_restart=True)
# the global recipe's hop_size 300 cuts the window to 8,100 samples (the
# collater takes whole hops), which the 64x encoder and decoder return as
# 8,128: the STFT loss then fails on the two lengths, in the JAX step as
# in the port's. Its windows are cut at hop 64, the local recipe's, to the
# full 8,192
VQVAE_V3_HOP_CUT = dict(hop_size=64)
# UHiFiGAN v1 (egs/opencpop/voc1/conf/uhifigan.v1.yaml: the sine-excitation
# U-Net of 32 channels rising to 512, downsampling 5 x 5 x 4 x 3,
# upsampling 3 x 4 x 5 x 5, MRF kernels 3, 7, 11 with dilations 1, 3, 5,
# dropout 0.1; the multi-scale multi-period discriminator; STFT, mel and
# feature-matching losses; Adam + MultiStepLR), every key of the yaml but
# the cut ones (UHIFIGAN_V1_TRAIN_CUT) and the data format of a seeded npy
# corpus: held to the yaml by test_smoke_uhifigan_config_is_the_opencpop_yaml
UHIFIGAN_V1_TRAIN = {
    "sampling_rate": 24000, "fft_size": 2048, "hop_size": 300,
    "win_length": 1200, "window": "hann", "num_mels": 80, "fmin": 80,
    "fmax": 7600, "global_gain_scale": 1.0, "trim_silence": False,
    "trim_threshold_in_db": 60, "trim_frame_size": 2048,
    "trim_hop_size": 256, "format": "npy", "use_f0": True,
    "use_excitation": True,
    "generator_type": "UHiFiGANGenerator",
    "generator_params": {
        "in_channels": 80, "out_channels": 1, "channels": 32,
        "kernel_size": 7, "downsample_scales": [5, 5, 4, 3],
        "downsample_kernel_sizes": [10, 10, 8, 6],
        "upsample_scales": [3, 4, 5, 5],
        "upsample_kernel_sizes": [6, 8, 10, 10],
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        "dropout": 0.1, "use_additional_convs": True, "bias": True,
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.1},
        "use_weight_norm": True,
    },
    "discriminator_type": "HiFiGANMultiScaleMultiPeriodDiscriminator",
    "discriminator_params": {
        "scales": 3, "scale_downsample_pooling": "AvgPool1d",
        "scale_downsample_pooling_params": {"kernel_size": 4, "stride": 2,
                                            "padding": 2},
        "scale_discriminator_params": {
            "in_channels": 1, "out_channels": 1,
            "kernel_sizes": [15, 41, 5, 3], "channels": 128,
            "max_downsample_channels": 1024, "max_groups": 16, "bias": True,
            "downsample_scales": [2, 2, 4, 4, 1],
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.1},
        },
        "follow_official_norm": True,
        "periods": [2, 3, 5, 7, 11],
        "period_discriminator_params": {
            "in_channels": 1, "out_channels": 1, "kernel_sizes": [5, 3],
            "channels": 32, "downsample_scales": [3, 3, 3, 3, 1],
            "max_downsample_channels": 1024, "bias": True,
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.1},
            "use_weight_norm": True, "use_spectral_norm": False,
        },
    },
    "use_stft_loss": True,
    "stft_loss_params": {"fft_sizes": [1024, 2048, 512],
                         "hop_sizes": [120, 240, 50],
                         "win_lengths": [600, 1200, 240],
                         "window": "hann_window"},
    "use_mel_loss": True,
    "mel_loss_params": {"fs": 24000, "fft_size": 2048, "hop_size": 300,
                        "win_length": 1200, "window": "hann", "num_mels": 80,
                        "fmin": 0, "fmax": 12000, "log_base": None},
    "generator_adv_loss_params": {"average_by_discriminators": False},
    "discriminator_adv_loss_params": {"average_by_discriminators": False},
    "use_feat_match_loss": True,
    "feat_match_loss_params": {"average_by_discriminators": False,
                               "average_by_layers": False,
                               "include_final_outputs": False},
    "lambda_aux": 45.0, "lambda_adv": 1.0, "lambda_feat_match": 2.0,
    "batch_size": 16, "batch_max_steps": 8400,
    "remove_short_samples": False, "allow_cache": True,
    "generator_optimizer_type": "Adam",
    "generator_optimizer_params": {"lr": 0.0002, "betas": [0.5, 0.9],
                                   "weight_decay": 0.0},
    "generator_scheduler_type": "MultiStepLR",
    "generator_scheduler_params": {
        "gamma": 0.5, "milestones": [200000, 400000, 600000, 800000]},
    "generator_grad_norm": -1,
    "discriminator_optimizer_type": "Adam",
    "discriminator_optimizer_params": {"lr": 0.0002, "betas": [0.5, 0.9],
                                       "weight_decay": 0.0},
    "discriminator_scheduler_type": "MultiStepLR",
    "discriminator_scheduler_params": {
        "gamma": 0.5, "milestones": [200000, 400000, 600000, 800000]},
    "discriminator_grad_norm": -1,
    "generator_train_start_steps": 1,
    "discriminator_train_start_steps": 0,
}
# three steps of 2,500,000 (step 0 trains nothing, D from step 1, G from
# step 2: the recipe's gates, strict), one evaluation, one checkpoint
UHIFIGAN_V1_TRAIN_CUT = dict(train_max_steps=3, save_interval_steps=3,
                             eval_interval_steps=3, log_interval_steps=1)
# step 14 (e)'s gate window: 4,200 samples (14 frames), cut from the
# recipe's 8,400 to make room for step 16
UHIFIGAN_GATE_SAMPLES = 4200
UHIFIGAN_LOSS_NAMES = ("spectral_convergence_loss", "log_stft_magnitude_loss",
                       "mel_loss", "adversarial_loss", "feature_matching_loss",
                       "generator_loss", "real_loss", "fake_loss",
                       "discriminator_loss")
UHIFIGAN_SR, UHIFIGAN_HOP = 24000, 300
# 32 x 512 frames = 4,915,200 samples = 204.8 s of 24 kHz audio a call
UHIFIGAN_BENCH_BATCH, UHIFIGAN_BENCH_FRAMES = 32, 512

# step 15: the discrete-symbol recipes, every key of their yaml (the data
# format that of a seeded npy corpus), held to the yaml by
# test_smoke_discrete_recipes_are_the_yaml. The token recipe
# (egs/vctk/hubert_voc1/conf/hifigan_hubert.v1.yaml: 100 HuBERT units,
# 128 speakers added to the 512-wide units, a HiFi-GAN trunk of 512
# channels upsampling 10 x 8 x 2 x 2; the multi-scale multi-period
# discriminator; mel loss x 45 and feature matching)
_HUBERT_HIFIGAN_V1 = {
    "sampling_rate": 16000, "fft_size": None, "hop_size": 320,
    "win_length": None, "window": None, "num_mels": 2, "fmin": None,
    "fmax": None, "global_gain_scale": 1.0, "trim_silence": False,
    "trim_threshold_in_db": 20, "trim_frame_size": 1024,
    "trim_hop_size": 256, "format": "npy",
    "generator_type": "DiscreteSymbolHiFiGANGenerator",
    "generator_params": {
        "in_channels": 512, "out_channels": 1, "channels": 512,
        "num_embs": 100, "num_spk_embs": 128, "spk_emb_dim": 512,
        "concat_spk_emb": False, "kernel_size": 7,
        "upsample_scales": [10, 8, 2, 2],
        "upsample_kernel_sizes": [20, 16, 4, 4],
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        "use_additional_convs": True, "bias": True,
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.1},
        "use_weight_norm": True,
    },
    "discriminator_type": "HiFiGANMultiScaleMultiPeriodDiscriminator",
    "discriminator_params": {
        "scales": 3, "scale_downsample_pooling": "AvgPool1d",
        "scale_downsample_pooling_params": {"kernel_size": 4, "stride": 2,
                                            "padding": 2},
        "scale_discriminator_params": {
            "in_channels": 1, "out_channels": 1,
            "kernel_sizes": [15, 41, 5, 3], "channels": 128,
            "max_downsample_channels": 1024, "max_groups": 16, "bias": True,
            "downsample_scales": [4, 4, 4, 4, 1],
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.1},
        },
        "follow_official_norm": True,
        "periods": [2, 3, 5, 7, 11],
        "period_discriminator_params": {
            "in_channels": 1, "out_channels": 1, "kernel_sizes": [5, 3],
            "channels": 32, "downsample_scales": [3, 3, 3, 3, 1],
            "max_downsample_channels": 1024, "bias": True,
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.1},
            "use_weight_norm": True, "use_spectral_norm": False,
        },
    },
    "use_stft_loss": False,
    "use_mel_loss": True,
    "mel_loss_params": {"fs": 16000, "fft_size": 1024, "hop_size": 256,
                        "win_length": None, "window": "hann", "num_mels": 80,
                        "fmin": 0, "fmax": 8000, "log_base": None},
    "generator_adv_loss_params": {"average_by_discriminators": False},
    "discriminator_adv_loss_params": {"average_by_discriminators": False},
    "use_feat_match_loss": True,
    "feat_match_loss_params": {"average_by_discriminators": False,
                               "average_by_layers": False,
                               "include_final_outputs": True},
    "lambda_aux": 45.0, "lambda_adv": 1.0, "lambda_feat_match": 2.0,
    "batch_size": 16, "batch_max_steps": 10240,
    "remove_short_samples": False, "allow_cache": True,
    "generator_optimizer_type": "Adam",
    "generator_optimizer_params": {"lr": 0.0002, "betas": [0.5, 0.9],
                                   "weight_decay": 0.0},
    "generator_scheduler_type": "MultiStepLR",
    "generator_scheduler_params": {
        "gamma": 0.5, "milestones": [200000, 400000, 600000, 800000]},
    "generator_grad_norm": -1,
    "discriminator_optimizer_type": "Adam",
    "discriminator_optimizer_params": {"lr": 0.0002, "betas": [0.5, 0.9],
                                       "weight_decay": 0.0},
    "discriminator_scheduler_type": "MultiStepLR",
    "discriminator_scheduler_params": {
        "gamma": 0.5, "milestones": [200000, 400000, 600000, 800000]},
    "discriminator_grad_norm": -1,
    "generator_train_start_steps": 1,
    "discriminator_train_start_steps": 0,
    "train_max_steps": 2500000, "save_interval_steps": 50000,
    "eval_interval_steps": 1000, "log_interval_steps": 100,
}


def _opencpop_token(generator_type: str, **generator_params) -> dict:
    """An opencpop token recipe: the token recipe's trunk, discriminator,
    losses and optimizers without speakers, at 250,000 steps."""
    gp = {k: v for k, v in _HUBERT_HIFIGAN_V1["generator_params"].items()
          if k not in ("num_embs", "num_spk_embs", "spk_emb_dim",
                       "concat_spk_emb")}
    config = {k: v for k, v in _HUBERT_HIFIGAN_V1.items()
              if k not in ("generator_adv_loss_params",
                           "discriminator_adv_loss_params")}
    return dict(config, generator_type=generator_type, num_mels=1,
                trim_threshold_in_db=35, allow_cache=False,
                train_max_steps=250000, eval_interval_steps=10000,
                generator_params=dict(gp, **generator_params))


DISCRETE_RECIPES = {
    "token": _HUBERT_HIFIGAN_V1,
    # egs/opencpop/token_voc1/conf/hifigan_token_16k_duration.v1.yaml:
    # 1,024 singing tokens (+1 padding row), the duration predictor of 2 x
    # 384 with dropout 0.5 (its defaults) and the duration loss,
    # max_reg_len 2,048 in serving
    "duration": dict(
        _opencpop_token("DiscreteSymbolDurationGenerator", num_embs=1024,
                        num_spk_embs=0, max_reg_len=2048),
        use_duration_loss=True),
    # egs/opencpop/token_voc1/conf/hifigan_token_24k_nodp_f0.v1.yaml: 1,025
    # tokens and the f0 through a 256-wide Linear, at 24 kHz
    "f0": dict(
        _opencpop_token(
            "DiscreteSymbolF0Generator", num_embs=1025, num_spk_embs=0,
            linear_channel=256, use_embedding_feats=False,
            use_weight_sum=False, layer_num=12, use_fix_weight=False,
            use_f0=True),
        sampling_rate=24000, use_f0=True,
        mel_loss_params=dict(_HUBERT_HIFIGAN_V1["mel_loss_params"],
                             fs=24000, fmax=12000)),
    # egs/vctk/hubert_voc1/conf/style_melgan_hubert.v1.yaml: 100 units, 128
    # speakers, the TADE trunk on a noise grid of 56 frames (1.12 s), the
    # random-window discriminator
    "style": {
        "sampling_rate": 16000, "fft_size": None, "hop_size": 320,
        "win_length": None, "window": None, "num_mels": 1, "fmin": None,
        "fmax": None, "global_gain_scale": 1.0, "trim_silence": False,
        "trim_threshold_in_db": 60, "trim_frame_size": 1024,
        "trim_hop_size": 256, "format": "npy",
        "generator_type": "DiscreteSymbolStyleMelGANGenerator",
        "generator_params": {
            "in_channels": 128, "aux_channels": 128, "channels": 64,
            "out_channels": 1, "num_embs": 100, "num_spk_embs": 128,
            "spk_emb_dim": 128, "concat_spk_emb": False, "kernel_size": 9,
            "dilation": 2, "bias": True,
            "noise_upsample_scales": [7, 2, 2, 2],
            "noise_upsample_activation": "LeakyReLU",
            "noise_upsample_activation_params": {"negative_slope": 0.2},
            "upsample_scales": [5, 2, 2, 2, 2, 2, 2, 1, 1],
            "upsample_mode": "nearest", "gated_function": "softmax",
            "use_weight_norm": True,
        },
        "discriminator_type": "StyleMelGANDiscriminator",
        "discriminator_params": {
            "repeats": 4, "window_sizes": [512, 1024, 2048, 4096],
            "pqmf_params": [[1, None, None, None], [2, 62, 0.267, 9.0],
                            [4, 62, 0.142, 9.0], [8, 62, 0.07949, 9.0]],
            "discriminator_params": {
                "out_channels": 1, "kernel_sizes": [5, 3], "channels": 16,
                "max_downsample_channels": 512, "bias": True,
                "downsample_scales": [4, 4, 4, 1],
                "nonlinear_activation": "LeakyReLU",
                "nonlinear_activation_params": {"negative_slope": 0.2},
            },
            "use_weight_norm": True,
        },
        "stft_loss_params": STYLE_MELGAN_V1_TRAIN["stft_loss_params"],
        "lambda_aux": 1.0, "lambda_adv": 1.0,
        "generator_adv_loss_params": {"average_by_discriminators": False},
        "discriminator_adv_loss_params": {"average_by_discriminators": False},
        "batch_size": 16, "batch_max_steps": 17920,
        "remove_short_samples": False, "allow_cache": True,
        "generator_optimizer_type": "Adam",
        "generator_optimizer_params": {"lr": 0.0001, "betas": [0.5, 0.9],
                                       "weight_decay": 0.0},
        "generator_scheduler_type": "MultiStepLR",
        "generator_scheduler_params": {
            "gamma": 0.5,
            "milestones": [100000, 300000, 500000, 700000, 900000]},
        "generator_grad_norm": -1,
        "discriminator_optimizer_type": "Adam",
        "discriminator_optimizer_params": {"lr": 0.0002, "betas": [0.5, 0.9],
                                           "weight_decay": 0.0},
        "discriminator_scheduler_type": "MultiStepLR",
        "discriminator_scheduler_params": {
            "gamma": 0.5, "milestones": [200000, 400000, 600000, 800000]},
        "discriminator_grad_norm": -1,
        "discriminator_train_start_steps": 100000,
        "train_max_steps": 1500000, "save_interval_steps": 50000,
        "eval_interval_steps": 1000, "log_interval_steps": 100,
    },
}
DISCRETE_SR, DISCRETE_HOP = 16000, 320
# the duration recipe's training: 3 f32 steps (D from step 1, G from step
# 2), one evaluation, one checkpoint
DURATION_TRAIN_CUT = dict(train_max_steps=3, save_interval_steps=3,
                          eval_interval_steps=3, log_interval_steps=1)
# one f32 (G, adv, D) step of the other three recipes at their full batch:
# three steps under the recipes' gates (step 0 trains nothing, the token
# recipes' D from step 1 and G from step 2), no evaluation; the token
# StyleMelGAN's D from step 1, as step 12 cuts it
ONE_STEP_CUT = dict(train_max_steps=3, save_interval_steps=3,
                    eval_interval_steps=100, log_interval_steps=1)
DISCRETE_LOSS_NAMES = ("mel_loss", "adversarial_loss",
                       "feature_matching_loss", "generator_loss",
                       "real_loss", "fake_loss", "discriminator_loss")
# 32 x 512 tokens = 5,242,880 samples = 327.7 s of 16 kHz audio a call
DISCRETE_BENCH_BATCH, DISCRETE_BENCH_FRAMES = 32, 512
# a predicted duration that flips between card and CPU must lie within this
# of a rounding tie in float64: |exp(d) - offset - (k + 1/2)|
DURATION_TIE = 1e-4
DURATION_FLIP_SHARE = 0.01
# the CPU reference of the duration model serves at this max_reg_len (the
# card at the recipe's 2,048): the valid frames (sum(ds) <= 448 checked)
# and the trunk's reach of a few frames lie inside it, and the zero fill
# past the sum is the same, so the valid samples are the same function;
# the CPU's 2,048-frame forward takes about 8 s an utterance
DURATION_CPU_REG_LEN = 512
# step 19: one f32 (G, adv, D) step of each recipe this script trains, at
# its width and batch as the training steps cut it, under the op census
# (parallelwavegan_torch/tools/op_census.py)
CENSUS_RECIPES = {
    "PWG v1": PWG_V1,
    "HiFi-GAN v1": HIFIGAN_V1_TRAIN,
    "MB-MelGAN v2": dict(MB_MELGAN_V2_TRAIN, **MB_MELGAN_V2_TRAIN_CUT),
    "PWG v3": dict(PWG_V3_TRAIN, **PWG_V3_TRAIN_CUT),
    "StyleMelGAN v1": dict(STYLE_MELGAN_V1_TRAIN, **STYLE_MELGAN_V1_TRAIN_CUT),
    "VQ-VAE": dict(VQVAE_V3_TRAIN, **VQVAE_V3_TRAIN_CUT, **VQVAE_V3_HOP_CUT),
    "UHiFiGAN": dict(UHIFIGAN_V1_TRAIN, **UHIFIGAN_V1_TRAIN_CUT),
    "duration": dict(DISCRETE_RECIPES["duration"], **DURATION_TRAIN_CUT),
}
N_SCORED = 8       # utterances scored on the host (about 20 s each)
N_CALIB = 8        # utterances the int8 scales are calibrated on
# the scored numbers against the committed CPU reference of the JAX package
QUALITY_TOL = {"mcd": 0.02, "log_f0_rmse": 0.002, "vuv_error": 0.002}

LOSS_NAMES = (
    "spectral_convergence_loss", "log_stft_magnitude_loss",
    "adversarial_loss", "generator_loss", "real_loss", "fake_loss",
    "discriminator_loss",
)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# kernel name -> the largest max |a - b| / (1 + max |plain|) of the checks
# that make up its max_abs_err: the quantity the tolerances hold
REL_ERR: dict = {}


def time_each_ms(fn, reps: int, warmup: int = 1) -> list:
    """Device ms of each of ``reps`` calls (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def max_err(a: torch.Tensor, b: torch.Tensor, dtype, kernel=None) -> tuple:
    """(max |a - b|, allowed) with allowed = tol * (1 + max |b|); the
    relative error is kept under ``kernel`` where one is named (or under
    each of a tuple of names)."""
    a, b = a.float(), b.float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite values")
    err, scale = (a - b).abs().max().item(), 1 + b.abs().max().item()
    for name in ((kernel,) if isinstance(kernel, str) else kernel or ()):
        REL_ERR[name] = max(REL_ERR.get(name, 0.0), err / scale)
    return err, TOL[dtype] * scale


def stack_inputs(gen: torch.Generator, B, T, L, dtype, dev):
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    w = {"w_tap": rnd(L, 3, 64, 128, scale=0.1), "b_tap": rnd(L, 128, scale=0.1),
         "w_aux": rnd(L, 80, 128, scale=0.1), "w_so": rnd(L, 64, 128, scale=0.1),
         "b_so": rnd(L, 128, scale=0.1)}
    return rnd(B, T, 64), rnd(B, T, 80), w


def check(what: str, got: torch.Tensor, want: torch.Tensor, dtype,
          kernel=None) -> float:
    """Print and enforce max |got - want| <= TOL[dtype] * (1 + max |want|)."""
    err, allowed = max_err(got, want, dtype, kernel)
    print(f"{what}: max_abs_err {err:.3e} (allowed {allowed:.3e})")
    if err > allowed:
        raise AssertionError(f"{what} disagrees with its plain version")
    return err


def stack_grads(fn, x, c, w, dils, ux, us):
    """Gradients of sum(x_out * ux) + sum(skip * us) through ``fn`` with
    respect to x, c and every weight: {"dx", "dc", "w_tap", ...}."""
    x = x.detach().requires_grad_()
    c = c.detach().requires_grad_()
    w = {k: v.detach().requires_grad_() for k, v in w.items()}
    xo, sk = fn(x, c, w, dils)
    loss = (xo.float() * ux).sum() + (sk * us).sum()
    names = list(w)
    grads = torch.autograd.grad(loss, [x, c] + [w[k] for k in names])
    return dict(zip(["dx", "dc"] + names, grads))


def check_training_kernels(gen: torch.Generator, dev, cases) -> dict:
    """The forward kernel with saved inputs and the backward kernel against
    their plain versions (autograd through the plain forward), every
    output. The weight gradients are sums over B*T rows taken in another
    order than autograd's matmuls take them; relative to the largest
    entry that stays well inside the elementwise tolerance, so one
    tolerance holds for every output. Returns the largest error seen."""
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        wavenet_stack,
        wavenet_stack_reference,
    )
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        wavenet_stack_backward,
        wavenet_stack_backward_reference,
        wavenet_stack_train,
        wavenet_stack_train_reference,
    )

    worst = {"wavenet_stack": 0.0, "wavenet_stack_backward": 0.0}
    for dtype, B, T, dils in cases:
        tag = (f"{str(dtype)[6:]} B={B} T={T} L={len(dils)} "
               f"max_d={max(dils)}")
        x, c, w = stack_inputs(gen, B, T, len(dils), dtype, dev)
        xo, sk, xs = wavenet_stack(x, c, w, dils, save_inputs=True)
        torch.cuda.synchronize()
        plain = wavenet_stack_reference(x, c, w, dils, save_inputs=True)
        for what, a, b in zip(("x", "skip", "xs"), (xo, sk, xs), plain):
            err = check(f"stack+save_inputs {tag} {what}", a, b, dtype,
                        "wavenet_stack")
            worst["wavenet_stack"] = max(worst["wavenet_stack"], err)
        ux = torch.randn(xo.shape, generator=gen).to(dev)
        us = torch.randn(sk.shape, generator=gen).to(dev)
        names = backward_err_names(dtype)
        # the kernel and its explicit plain version on the same saved inputs
        got = wavenet_stack_backward(xs, c, w, dils, ux.to(dtype), us)
        torch.cuda.synchronize()
        want = wavenet_stack_backward_reference(xs, c, w, dils,
                                                ux.to(dtype), us)
        for what, a, b in backward_outputs(got, want):
            err = check(f"stack backward {tag} {what} (explicit plain)", a,
                        b, dtype, names)
            worst["wavenet_stack_backward"] = max(
                worst["wavenet_stack_backward"], err)
        got = stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
        torch.cuda.synchronize()
        want = stack_grads(wavenet_stack_train_reference, x, c, w, dils, ux,
                           us)
        for what in want:
            err = check(f"stack backward {tag} {what}", got[what],
                        want[what], dtype, names)
            worst["wavenet_stack_backward"] = max(
                worst["wavenet_stack_backward"], err)
    return worst


def backward_err_names(dtype) -> tuple:
    """REL_ERR keys of a backward check: every check counts towards the
    kernel's max_rel_err, a bf16 one also towards its bf16_max_rel_err."""
    return ("wavenet_stack_backward",) + (
        ("wavenet_stack_backward_bf16",) if dtype == torch.bfloat16 else ())


def backward_outputs(got, want):
    """(name, kernel output, plain output) of two (dx, dc, {weight grads})."""
    return [("dx", got[0], want[0]), ("dc", got[1], want[1])] + [
        (k, got[2][k], want[2][k]) for k in want[2]]


def stack_bound_ms(B, T, L, dtype, body: str) -> tuple:
    """Least time for the stack call on the body its launch plan names:
    operations at the body's peak vs bytes (x, c in; x out; skip out f32;
    weights) at the memory rate. The f32 body (``tensor_cores_tf32x3``)
    does every product as three TF32 products, so its peak is the TF32 rate
    over three; otherwise the type's peak."""
    R, G, S, A = 64, 128, 64, 80
    flops = stack_flops(B, T, L)
    item = torch.finfo(dtype).bits // 8
    weights = L * (3 * R * G + G + A * G + R * (S + R) + S + R) * item
    nbytes = B * T * ((2 * R + A) * item + S * 4) + weights
    peak = (PEAK_TF32_FLOPS / 3 if body == "tensor_cores_tf32x3"
            else PEAK_FLOPS[dtype])
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def stack_flops(B, T, L) -> float:
    R, G, S, A = 64, 128, 64, 80
    return 2.0 * (3 * R * G + A * G + R * (S + R)) * B * T * L


def layer_bytes_floor_ms(B, T, L, dtype) -> float:
    """Least time of the stack as one launch per layer: each launch reads x
    (f32, 256 B a row), c (80 channels in ``dtype``: 160 B in bf16, 320 B
    in f32) and skip (f32, 256 B) and writes x and skip (512 B), 1,184 B a
    row in bf16 and 1,344 B in f32, at the memory rate."""
    row = 1024 + 80 * (torch.finfo(dtype).bits // 8)
    return row * B * T * L / PEAK_BYTES_PER_S * 1e3


def backward_bound_ms(B, T, L, A, dtype, body: str) -> tuple:
    """Least time for the stack backward on the body its launch plan names:
    3 (3R + A) G + 2 R (S + R) MAC per row and layer at the body's peak vs
    the bytes that must move (xs, c and the cotangents in, dx and dc out,
    weights in, their gradients out). The gate product is recomputed and
    then transposed twice (dz . W^T and in^T . dz); the skip/out 1x1 is only
    transposed twice (dg = dso . Wso^T, dWso = g^T . dso): its forward
    output is never needed again. The f32 tensor-core body
    (``tensor_cores_tf32x3``) does every product as three TF32 products,
    so its peak is the TF32 rate over three; otherwise the type's peak."""
    R, G, S = 64, 128, 64
    flops = backward_flops(B, T, L, A)
    item = torch.finfo(dtype).bits // 8
    weights = L * (3 * R * G + G + A * G + R * (S + R) + S + R) * item
    nbytes = (B * T * (L * R * item + A * item + S * 4 + 2 * R * item
                       + A * item) + 2 * weights)
    peak = (PEAK_TF32_FLOPS / 3 if body == "tensor_cores_tf32x3"
            else PEAK_FLOPS[dtype])
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def backward_flops(B, T, L, A) -> float:
    """3 (3R + A) G + 2 R (S + R) multiply-adds per row and layer."""
    R, G, S = 64, 128, 64
    return 2.0 * (3 * (3 * R + A) * G + 2 * R * (S + R)) * B * T * L


def bwd_bytes_floor_ms(B, T, L, A, dtype) -> float:
    """Least time of the backward as two launches a layer, at the memory
    rate: the bytes the body of ``dtype`` moves per row and layer, each
    read or write once. Both bodies' data launch reads D and writes it back
    (512 B), reads the three tap rows of the layer above (768 B), writes
    its own taps (768 B) and reads and writes dc (8 A B), all f32. float32:
    the data launch also reads xs and c and writes dz (512 B) and g
    (256 B); the weight launch reads xs, c, g, dz and dso (dskip and D,
    512 B), all f32: 5,888 B at A = 80. bfloat16: the data launch also
    reads xs, c and dskip and writes dz, g and bf16(D sqrt(1/2)), all bf16;
    the weight launch reads those six, all bf16: 4,544 B at A = 80. Left
    out: the weight launch's partials and the bf16 column sums (fixed per
    launch, about 1 % at the training shape) and what a call does once
    (dskip to bf16, dx)."""
    f32 = 512 + 768 + 768 + 8 * A
    if dtype == torch.float32:
        data = f32 + (64 + A) * 4 + 512 + 256
        weight = (64 + A) * 4 + 256 + 512 + 512
    else:
        data = f32 + (64 + A + 64) * 2 + 256 + 128 + 128
        weight = (64 + A) * 2 + 128 + 256 + 128 + 128
    return (data + weight) * B * T * L / PEAK_BYTES_PER_S * 1e3


def write_corpus(root: str, rng: np.random.Generator, n_utts: int = 8) -> None:
    """Seeded utterances as npy dumps: sines plus noise, and features of
    the right shape (frames, 80) drawn from the same seed."""
    os.makedirs(root)
    for i in range(n_utts):
        frames = 120 + 10 * i  # longer than the 100-frame training window
        t = np.arange(frames * HOP) / SR
        wave = sum(0.2 / (k + 1) * np.sin(2 * np.pi * (110 * (i + 1)) * (k + 1)
                                          * t) for k in range(3))
        wave = wave + 0.01 * rng.standard_normal(t.shape)
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                wave.astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"),
                rng.standard_normal((frames, 80)).astype(np.float32))


def check_trainer(trainer, what: str, names=LOSS_NAMES,
                  eval_names=None) -> None:
    for split, losses, want in (
            ("train", trainer.last_train_loss, names),
            ("eval", trainer.last_eval_loss,
             names if eval_names is None else eval_names)):
        if split == "eval" and not losses:  # a run without an eval epoch
            continue
        if sorted(losses) != sorted(f"{split}/{n}" for n in want):
            raise AssertionError(f"{what}: {split} losses {sorted(losses)}")
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{what}: non-finite {split} loss {losses}")
        print(f"{what} {split}: " + ", ".join(
            f"{k.split('/')[1]} {v:.4f}" for k, v in sorted(losses.items())))


# batches of the loader the generator gradient is held on (step 6)
GRAD_BATCHES = 5
# step 6's gate: GATE_BATCH windows of a batch cut to GATE_SAMPLES samples
# (32 frames, more than PWG v1's receptive field of 6,139 samples, so that
# samples away from the edges are held), other windows and another offset
# for each of the GRAD_BATCHES (gate_window); the CPU's float64 route at
# 6 x 25,600 would take minutes a batch
GATE_BATCH, GATE_SAMPLES = 1, 8192
# stack_grads' keys -> the backward's output names in the kernels line
BWD_OUTPUT_NAMES = {"dx": "dx", "dc": "dc", "w_tap": "dWt", "b_tap": "dbt",
                    "w_aux": "dWa", "w_so": "dWso", "b_so": "dbso"}


def training_phase(dev, smi: str) -> dict:
    """Steps 5 and 6 of the module docstring. Returns what the kernels line
    needs: launches on the training path, errors and times."""
    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine import checkpoint as ckpt
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.ops.cuda import pwg_infer
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        stack_launch_plan,
        wavenet_stack,
        wavenet_stack_reference,
    )
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        backward_launch_plan,
        wavenet_stack_backward,
        wavenet_stack_backward_reference,
        wavenet_stack_train,
        wavenet_stack_train_reference,
    )
    from parallelwavegan_torch.tools.float64_check import hold_to_float64

    rng = np.random.default_rng(1)
    L = PWG_V1["generator_params"]["layers"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the backward's plan for one group of ten layers in each precision
    bwd_plans = {dtype: backward_launch_plan(TRAIN_BATCH, TRAIN_SAMPLES, 80,
                                             L // 3, dtype, sms)
                 for dtype in (torch.float32, torch.bfloat16)}
    print(f"backward launch plans per group: {bwd_plans}")
    # the step runs the stack as three groups of ten layers; the forward
    # kernel's launches per forward follow its plan in each precision
    launches_per_forward = {
        dtype: 3 * stack_launch_plan(TRAIN_BATCH, TRAIN_SAMPLES, 80, L // 3,
                                     dtype)["launches"]
        for dtype in (torch.float32, torch.bfloat16)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_corpus(dump, rng)

        # 5. six f32 steps through the entry point a user calls. Steps 1..5
        # update G (step 0 trains nothing: the gates are strict), steps 3..5
        # add the adversarial loss and update D, step 6 evaluates one batch
        # and dumps its prediction.
        g_updates, d_updates, eval_forwards = 5, 3, 2
        initial, _, _, _, _ = init_train_state(PWG_V1, seed=0, device=dev)
        torch.cuda.synchronize()
        wavenet_stack.launches = wavenet_stack_backward.launches = 0
        t0 = time.perf_counter()
        trainer = run(PWG_V1, dump, dump, os.path.join(tmp, "exp"), seed=0,
                      device="cuda", dump_config=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["fwd_launches"] = wavenet_stack.launches
        out["bwd_launches"] = wavenet_stack_backward.launches
        print(f"training path f32 {TRAIN_BATCH} x {TRAIN_SAMPLES} samples: "
              f"{trainer.steps} steps in {wall:.1f} s wall (first calls), "
              f"wavenet_stack launches {out['fwd_launches']}, backward "
              f"launches {out['bwd_launches']}")
        if trainer.steps != 6 or trainer.device.type != "cuda":
            raise AssertionError("the trainer did not take 6 steps on cuda")
        if out["fwd_launches"] != launches_per_forward[torch.float32] * (
                g_updates + d_updates + eval_forwards):
            raise AssertionError("unexpected forward kernel launches")
        if out["bwd_launches"] != 3 * bwd_plans[torch.float32][
                "launches"] * g_updates:
            raise AssertionError("unexpected backward kernel launches")
        check_trainer(trainer, "training path f32")
        # the last layer's residual 1x1 (v, g, bias) feeds nothing, and
        # first_conv's kernel_v has a zero gradient but for rounding
        check_moved("G", trainer.generator, initial.generator, 4)
        check_moved("D", trainer.discriminator, initial.discriminator, 4)
        path = os.path.join(tmp, "exp", "checkpoint-6steps.ckpt")
        ckpt.load_checkpoint(path, initial)
        if initial.steps != 6 or initial.opt_g.count != g_updates \
                or initial.opt_d.count != d_updates:
            raise AssertionError("the .ckpt did not restore the counters")
        for module, loaded in ((trainer.generator, initial.generator),
                               (trainer.discriminator, initial.discriminator)):
            want = dict(module.named_parameters())
            for key, p in loaded.named_parameters():
                if not torch.equal(p, want[key]):
                    raise AssertionError(f".ckpt differs on {key}")
        print(f"  {os.path.basename(path)} "
              f"({os.path.getsize(path) / 1e6:.1f} MB) loads back")
        del initial

        # two more steps in mixed precision, resumed from that checkpoint
        mixed_config = dict(PWG_V1, mixed_precision=True, train_max_steps=8,
                            eval_interval_steps=1000, log_interval_steps=2,
                            save_interval_steps=1000)
        wavenet_stack.launches = wavenet_stack_backward.launches = 0
        mixed = run(mixed_config, dump, dump, os.path.join(tmp, "exp_mixed"),
                    resume=path, seed=0, device="cuda", dump_config=False)
        torch.cuda.synchronize()
        print(f"training path mixed precision: steps 6 -> {mixed.steps}, "
              f"wavenet_stack launches {wavenet_stack.launches}, backward "
              f"launches {wavenet_stack_backward.launches}")
        if mixed.steps != 8 \
                or wavenet_stack.launches != 4 * launches_per_forward[
                    torch.bfloat16] \
                or wavenet_stack_backward.launches != 2 * 3 * bwd_plans[
                    torch.bfloat16]["launches"]:
            raise AssertionError("unexpected launches in mixed precision")
        check_trainer(mixed, "training path mixed")
        if any(p.dtype != torch.float32 for p in mixed.generator.parameters()):
            raise AssertionError("master parameters left float32")

        # 6. the generator and discriminator loss and every gradient on
        # GRAD_BATCHES batches of the loader, each cut to GATE_BATCH x
        # GATE_SAMPLES at its own windows and offset (gate_window): through
        # the kernels on the card in f32 (k), through their plain versions
        # on the CPU in f32 (p) and in float64 (e), the STFT loss's kinks
        # and the branches of G's ReLUs and D's LeakyReLUs decided once, by
        # float64, each set held to |k - e| <= max(2 |p - e|, a)
        # (gate_gradients, hold_gate: tools/float64_check.py)
        gen, dis = trainer.generator, trainer.discriminator
        losses = pwg_gate_losses(trainer.criterion)
        worst, gate_launches = {}, {"wavenet_stack": 0,
                                    "wavenet_stack_backward": 0}
        t_gate = time.perf_counter()
        for n in range(GRAD_BATCHES):
            b = mixed._to_device(next(iter(mixed.train_loader)))
            if n == 0:  # the timed steps below take the first batch
                batch = b
            before = (wavenet_stack.launches, wavenet_stack_backward.launches)
            got = gate_gradients(gate_routes(gen, dis, gate_window(b, n)),
                                 *losses)
            gate_launches["wavenet_stack"] += \
                wavenet_stack.launches - before[0]
            gate_launches["wavenet_stack_backward"] += \
                wavenet_stack_backward.launches - before[1]
            gate = hold_gate(f"pwg v1 batch {n}", got, GATE_SAMPLES,
                             GATE_BATCH)
            print(f"pwg v1 gate, batch {n}: worst "
                  + ", ".join(f"{k} {v:.3f}" for k, v in gate.items()))
            for key, value in gate.items():
                worst[key] = max(worst.get(key, 0.0), value)
            del got
        out["grad_gate"] = worst
        print(f"pwg v1 gradients over {GRAD_BATCHES} batches of "
              f"{GATE_BATCH} x {GATE_SAMPLES}, k through B1/B2 "
              f"({gate_launches['wavenet_stack']} forward and "
              f"{gate_launches['wavenet_stack_backward']} backward "
              f"launches): worst gate "
              + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
              + f" on {smi}; {time.perf_counter() - t_gate:.1f} s wall")
        if min(gate_launches.values()) < 1:
            raise AssertionError("the gate's k route did not run through "
                                 "the kernels")

        # timing: the (G, adv, D) step in f32 and in mixed precision
        for what, t in (("f32", trainer), ("mixed", mixed)):
            step = t.train_step_factory(True, True, True)
            out[f"step_ms_{what}"] = time_ms(lambda: step(t.state, batch),
                                             reps=3)
        profile_step(trainer, batch, "f32")
        profile_step(mixed, batch, "mixed")
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step_factory(True, True, True)(trainer.state, batch)
        torch.cuda.synchronize()
        out["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"(G, adv, D) step {TRAIN_BATCH} x {TRAIN_SAMPLES}: f32 "
              f"{out['step_ms_f32']:.1f} ms "
              f"({1e3 / out['step_ms_f32']:.2f} steps/s), mixed precision "
              f"{out['step_ms_mixed']:.1f} ms "
              f"({1e3 / out['step_ms_mixed']:.2f} steps/s), peak memory "
              f"{out['step_peak_gb']:.2f} GB on {smi}")

        # both kernels alone at the training shape, as the step calls them:
        # three groups of ten layers, f32, with the trained weights
        with torch.no_grad():
            w = pwg_infer.fuse_wavenet_stack_params(gen.conv_layers)
            c_up = gen.upsample_net(batch["c"]).contiguous()
            x0 = pwg_infer._conv1x1(gen.first_conv, batch["z"]).contiguous()
        dils = gen.dilations
        groups = [({k: v[g0:g0 + 10].contiguous() for k, v in w.items()},
                   tuple(dils[g0:g0 + 10])) for g0 in range(0, L, 10)]
        gen_t = torch.Generator().manual_seed(3)
        ux = torch.randn(x0.shape, generator=gen_t).to(dev)
        us = torch.randn(x0.shape, generator=gen_t).to(dev)
        wg, dg = groups[0]
        got = wavenet_stack(x0, c_up, wg, dg, save_inputs=True)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = wavenet_stack_reference(x0, c_up, wg, dg, save_inputs=True)
        out["fwd_err"] = max(
            check(f"stack+save_inputs at the training shape f32 {k}", a, b,
                  torch.float32, "wavenet_stack")
            for k, a, b in zip(("x", "skip", "xs"), got, want))
        # both against float64: the kernel's split-TF32 sums must stay as
        # close to the exact stack as the plain version's f32 sums (the
        # gradients through the STFT loss below amplify the forward's error)
        with torch.no_grad():
            exact = wavenet_stack_reference(
                x0.double(), c_up.double(),
                {k: v.double() for k, v in wg.items()}, dg)
        for k, a, b, e in zip(("x", "skip"), got, want, exact):
            ka, pa = hold_to_float64(
                f"wavenet_stack at the training shape f32 {k}", a, b, e)
            print(f"stack at the training shape f32 {k} against float64: "
                  f"kernel {ka:.3e}, plain {pa:.3e} of 1 + max")
        del exact
        xs = got[2]
        got = stack_grads(wavenet_stack_train, x0, c_up, wg, dg, ux, us)
        want = stack_grads(wavenet_stack_train_reference, x0, c_up, wg, dg,
                           ux, us)
        out["bwd_err"] = max(
            check(f"stack backward at the training shape f32 {k}", got[k],
                  want[k], torch.float32, "wavenet_stack_backward")
            for k in want)
        # every output of the backward against float64 too, on the same
        # inputs: the kernel may lie at most 2 x as far from the exact
        # gradient as the plain version's f32 sums
        exact = stack_grads(wavenet_stack_train_reference, x0.double(),
                            c_up.double(),
                            {k: v.double() for k, v in wg.items()}, dg,
                            ux.double(), us.double())
        out["bwd_f32_vs_float64"] = {}
        for k in exact:
            ka, pa = hold_to_float64(
                f"wavenet_stack_backward at the training shape f32 {k}",
                got[k], want[k], exact[k])
            out["bwd_f32_vs_float64"][BWD_OUTPUT_NAMES[k]] = [ka, pa]
            print(f"stack backward at the training shape f32 {k} against "
                  f"float64: kernel {ka:.3e}, plain {pa:.3e} of 1 + max")
        del got, want, exact

        def forward_groups(save):
            x = x0
            for wg, dg in groups:
                x = wavenet_stack(x, c_up, wg, dg, save_inputs=save)[0]

        def backward_groups():
            for wg, dg in groups:
                wavenet_stack_backward(xs, c_up, wg, dg, ux, us)

        out["fwd_train_ms"] = time_ms(lambda: forward_groups(True), reps=3)
        out["fwd_infer_ms"] = time_ms(lambda: forward_groups(False), reps=3)
        out["bwd_ms"] = time_ms(backward_groups, reps=3)

        # the plain versions over the same three groups: the forward as
        # one chain, the backward as autograd over graphs built (untimed)
        # before each repetition and freed by it
        def forward_plain():
            x = x0
            for wg, dg in groups:
                x = wavenet_stack_reference(x, c_up, wg, dg)[0]

        with torch.no_grad():
            out["fwd_plain_ms"] = time_ms(forward_plain, reps=2)

        xr = x0.detach().requires_grad_()
        cr = c_up.detach().requires_grad_()
        plain = []
        for wg, dg in groups:
            wr = {k: v.detach().requires_grad_() for k, v in wg.items()}
            plain.append((wr, dg, [xr, cr] + list(wr.values())))

        def plain_backward_ms():
            losses = []
            for wr, dg, _ in plain:
                xo, sk = wavenet_stack_reference(xr, cr, wr, dg)
                losses.append((xo * ux).sum() + (sk * us).sum())
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for loss, (_, _, leaves) in zip(losses, plain):
                torch.autograd.grad(loss, leaves)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        plain_backward_ms()  # warm-up
        out["bwd_plain_ms"] = sum(plain_backward_ms() for _ in range(2)) / 2
        del plain, xr, cr

        # the bf16 body alone at the same shape, on the same inputs and
        # weights rounded to bf16, as the mixed step runs it: held against
        # its explicit plain version on the same saved inputs and, through
        # autograd, against the plain forward's gradient, then timed
        bf = torch.bfloat16
        groups16 = [({k: v.to(bf) for k, v in wg.items()}, dg)
                    for wg, dg in groups]
        c16 = c_up.to(bf)
        wg16, dg16 = groups16[0]
        xs16 = wavenet_stack(x0.to(bf), c16, wg16, dg16, save_inputs=True)[2]
        err_names = backward_err_names(bf)
        got = wavenet_stack_backward(xs16, c16, wg16, dg16, ux.to(bf), us)
        torch.cuda.synchronize()
        want = wavenet_stack_backward_reference(xs16, c16, wg16, dg16,
                                                ux.to(bf), us)
        errs = [check(f"stack backward at the training shape bf16 {k} "
                      f"(explicit plain)", a, b, bf, err_names)
                for k, a, b in backward_outputs(got, want)]
        del got, want
        got = stack_grads(wavenet_stack_train, x0.to(bf), c16, wg16, dg16,
                          ux, us)
        want = stack_grads(wavenet_stack_train_reference, x0.to(bf), c16,
                           wg16, dg16, ux, us)
        errs += [check(f"stack backward at the training shape bf16 {k}",
                       got[k], want[k], bf, err_names) for k in want]
        out["bwd_err"] = max([out["bwd_err"]] + errs)
        del got, want

        def backward_groups_bf16():
            for wg, dg in groups16:
                wavenet_stack_backward(xs16, c16, wg, dg, ux, us)

        out["bwd_bf16_ms"] = time_ms(backward_groups_bf16, reps=3)
        del xs16, groups16, c16
    B, T = x0.shape[:2]
    A = c_up.shape[-1]
    out["bwd_plan"] = bwd_plans[torch.float32]
    out["bwd_bf16_plan"] = bwd_plans[torch.bfloat16]
    out["bwd_bound_ms"], out["bwd_bound_by"] = backward_bound_ms(
        B, T, L, A, torch.float32, out["bwd_plan"]["body"])
    out["bwd_bf16_bound_ms"], _ = backward_bound_ms(
        B, T, L, A, torch.bfloat16, out["bwd_bf16_plan"]["body"])
    out["bwd_bytes_floor_ms"] = bwd_bytes_floor_ms(B, T, L, A, torch.float32)
    out["bwd_bf16_bytes_floor_ms"] = bwd_bytes_floor_ms(B, T, L, A,
                                                        torch.bfloat16)
    out["bwd_bf16_tflop_per_s"] = (backward_flops(B, T, L, A)
                                   / out["bwd_bf16_ms"] / 1e9)
    out["fwd_plan"] = stack_launch_plan(B, T, A, L // 3, torch.float32, sms)
    out["fwd_bound_ms"], _ = stack_bound_ms(B, T, L, torch.float32,
                                            out["fwd_plan"]["body"])
    print(f"training shape f32 {B} x {T}, {L} layers in 3 groups: backward "
          f"kernel {out['bwd_ms']:.2f} ms on the "
          f"{out['bwd_plan']['body']} body (plain {out['bwd_plain_ms']:.2f} "
          f"ms, bound {out['bwd_bound_ms']:.2f} ms by "
          f"{out['bwd_bound_by']}, two-launch byte floor "
          f"{out['bwd_bytes_floor_ms']:.2f} ms); forward kernel with "
          f"saved inputs "
          f"{out['fwd_train_ms']:.2f} ms, without "
          f"{out['fwd_infer_ms']:.2f} ms (plain {out['fwd_plain_ms']:.2f} "
          f"ms, bound {out['fwd_bound_ms']:.2f} ms) on {smi}")
    print(f"training shape bf16 {B} x {T}, {L} layers in 3 groups: backward "
          f"kernel {out['bwd_bf16_ms']:.2f} ms on the "
          f"{out['bwd_bf16_plan']['body']} body "
          f"({out['bwd_bf16_tflop_per_s']:.1f} TFLOP/s; bound "
          f"{out['bwd_bf16_bound_ms']:.2f} ms by operations at the bf16 "
          f"peak, two-launch byte floor of what it moves "
          f"{out['bwd_bf16_bytes_floor_ms']:.2f} ms); plan "
          f"{out['bwd_bf16_plan']} on {smi}")
    print(f"training shape f32, the forward on the "
          f"{out['fwd_plan']['body']} body beside the backward: "
          f"wavenet_stack {out['fwd_train_ms']:.2f} ms with saved inputs, "
          f"wavenet_stack_backward {out['bwd_ms']:.2f} ms on {smi}")
    return out


def profile_step(trainer, batch, what: str) -> None:
    """Where one (G, adv, D) step's device time goes: torch.profiler over
    one step (the step is warm: the callers time it first), device time
    by kernel name. Printed, never a failure. One step, not two: over two
    the profiler's processing took about 30 s a call, and this runs
    fifteen times."""
    from parallelwavegan_torch.engine.step import (
        DROPOUT_STREAM,
        SHARED_STREAM,
        step_generator,
    )
    from parallelwavegan_torch.tools.train_step_profile import device_time

    step = trainer.train_step_factory(True, True, True)
    prof = device_time(lambda: step(
        trainer.state, batch, step_generator(0, trainer.state.steps),
        step_generator(0, trainer.state.steps, SHARED_STREAM),
        step_generator(0, trainer.state.steps, DROPOUT_STREAM,
                       trainer.device)), n=1, top=14)
    busy = prof["device_busy_ms"]
    if busy <= 0:
        print(f"step profile {what}: the profiler shows no device time")
        return
    print(f"step profile {what}: {prof['profiled_wall_ms']:.1f} ms wall a "
          f"step under the profiler, device busy {busy:.1f} ms; device time "
          f"by kernel:")
    for row in prof["kernels"]:
        print(f"  {row['ms']:8.2f} ms {100 * row['ms'] / busy:5.1f} %  "
              f"x{row['calls']:6.1f}  {row['name']}")


def score_utterance(job):
    """Worker-process entry: copy-synthesis metrics of one utterance with
    the port's numpy metrics. job = (name, wave, ground-truth wav, sr,
    whether to score f0 too)."""
    from parallelwavegan_torch.ops.eval_metrics import (
        log_f0_rmse,
        mel_cepstral_distortion,
    )
    from parallelwavegan_torch.utils.io import read_wav

    name, wave, gt_path, sr, with_f0 = job
    gt = read_wav(gt_path)[0]
    out = {"mcd": mel_cepstral_distortion(wave, gt, sr)}
    if with_f0:
        out["log_f0_rmse"], out["vuv_error"] = log_f0_rmse(wave, gt, sr)
    return name, out


def mrf_inputs(rng, C, kernels, dils):
    """Seeded weights and activation scales of one MRF stage."""
    weights = [[(rng.standard_normal((k, C, C)).astype(np.float32)
                 * (0.6 / np.sqrt(k * C)),
                 rng.standard_normal(C).astype(np.float32) * 0.05)
                for _ in range(len(dils) * 2)] for k in kernels]
    scales = [[np.abs(rng.standard_normal(C)).astype(np.float32) * 0.02 + 0.01
               for _ in range(len(dils) * 2)] for _ in kernels]
    return weights, scales


def check_mrf_and_matmul_kernels(dev) -> dict:
    """B3 and B5 against their plain versions at small and real widths.
    Tolerance as for the stack, tol * (1 + max |plain|) with tol 1e-4 in
    f32 and 2e-2 in bf16; the int8 packs pin their arithmetic (exact
    integer sums, an epilogue of two roundings), so they are held to the
    f32 tolerance when x is f32; matmul_bench's int32 results must be
    bit-equal. Returns the largest error seen per kernel."""
    from parallelwavegan_torch.ops.cuda.matmul_bench import (
        MRF_SHAPES,
        matmul_bench,
        matmul_bench_reference,
    )
    from parallelwavegan_torch.ops.cuda.mrf_stage import (
        build_stage_pack,
        mrf_stage,
        mrf_stage_reference,
    )
    from parallelwavegan_torch.tools.int8_stage_roofline import matmul_inputs

    v1 = ((3, 7, 11), (1, 3, 5))
    cases = [  # (C, T, B, kernels, dils): ragged T, below a tile, below reach
        (8, 300, 2, (3, 5, 7), (1, 2)), (16, 20, 1) + v1,
        (32, 1000, 2) + v1, (64, 333, 2) + v1, (128, 129, 1) + v1,
        (256, 260, 1) + v1, (32, 7, 3) + v1, (32, 300, 2, (3, 5, 7), (1, 2)),
        # one row past the fused body's second tile of the k = 11 branch
        (256, 237, 1) + v1, (32, 1005, 1) + v1,
    ]
    rng = np.random.default_rng(5)
    worst = {"mrf_stage": 0.0, "matmul_bench": 0.0}
    for C, T, B, kernels, dils in cases:
        weights, scales = mrf_inputs(rng, C, kernels, dils)
        x32 = torch.from_numpy(
            rng.standard_normal((B, T, C)).astype(np.float32)).to(dev)
        for mode, wdtype, xdtype in (
            ("f32", torch.float32, torch.float32),
            ("bf16", torch.bfloat16, torch.bfloat16),
            ("int8", None, torch.float32),
            ("int8, bf16 x", None, torch.bfloat16),
        ):
            quant = wdtype is None
            pack = build_stage_pack(weights, scales, quant=quant,
                                    dtype=wdtype or torch.float32, device=dev)
            x = x32.to(xdtype)
            out = mrf_stage(x, pack, kernels=kernels, dils=dils, quant=quant)
            torch.cuda.synchronize()
            ref = mrf_stage_reference(x, pack, kernels=kernels, dils=dils,
                                      quant=quant)
            err = check(f"mrf_stage {mode} C={C} B={B} T={T} k={kernels} "
                        f"d={dils}", out, ref, xdtype, "mrf_stage")
            worst["mrf_stage"] = max(worst["mrf_stage"], err)
    for M, K, N in [(m // 16, k, n) for m, k, n in MRF_SHAPES] + [
            (77, 50, 24), (1000, 96, 8), (999, 40, 16), (4097, 72, 24)]:
        for mode in ("int8", "bf16"):
            a, b = matmul_inputs(M, K, N, mode, dev)
            out = matmul_bench(a, b)
            torch.cuda.synchronize()
            ref = matmul_bench_reference(a, b)
            if mode == "int8":
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"matmul_bench int8 {M}x{K}x{N} is not bit-equal")
                print(f"matmul_bench int8 M={M} K={K} N={N}: bit-equal")
            else:
                err = check(f"matmul_bench bf16 M={M} K={K} N={N}", out, ref,
                            torch.float32, "matmul_bench")
                worst["matmul_bench"] = max(worst["matmul_bench"], err)
    return worst


VARIANTS = (("tanh", False), ("mul", False), ("tanh", True))
# x (1 + max |plain|). int8 taps: the quantiser is pinned and the tap sums are
# exact integers, so kernel and plain version differ only through the f32
# sums of the aux and skip|out products taken in another order: now and then
# one bf16 step of one g (2^-9 |w_so|, below 1e-3 at these weights) or one
# quantisation step of one later input (act_max / 127 times a tap weight,
# about 1e-3)
VARIANT_TOL = {False: TOL[torch.bfloat16], True: 2e-3}


def variant_name(gate: str, int8_taps: bool) -> str:
    return "int8_taps" if int8_taps else f"bf16_{gate}"


def variant_inputs(rng, B, T, L, dev):
    """Seeded weights (float32, the tool's scales), bf16 x and c."""
    def rnd(*shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    w = {"w_tap": rnd(L, 192, 128, scale=0.08), "b_tap": rnd(L, 128, scale=0.01),
         "w_aux": rnd(L, 80, 128, scale=0.08), "w_so": rnd(L, 64, 128, scale=0.08),
         "b_so": rnd(L, 128, scale=0.01)}
    return (w, rnd(B, T, 64, scale=0.3).to(torch.bfloat16),
            rnd(B, T, 80, scale=0.5).to(torch.bfloat16))


def check_variant(what, x, c, w, dils, gate, int8_taps) -> float:
    """One variant of B4 against its plain version; the int8 scales come
    from the plain bf16 variant's residual range, as the tool takes them
    from the baseline's. Returns the larger error of x and skip."""
    from parallelwavegan_torch.ops.cuda.wavenet_variant import (
        quantize_taps,
        variant_stack,
        variant_stack_reference,
    )

    s_tap = torch.ones((len(dils), 2), device=x.device)
    if int8_taps:
        x_plain, _ = variant_stack_reference(x, c, w, s_tap, dils)
        act_max = float(x_plain.float().abs().max()) * 1.05
        w_q, s_tap = quantize_taps(w["w_tap"], act_max)
        w = dict(w, w_tap_q=w_q)
    got = variant_stack(x, c, w, s_tap, dils, gate=gate, int8_taps=int8_taps)
    torch.cuda.synchronize()
    want = variant_stack_reference(x, c, w, s_tap, dils, gate=gate,
                                   int8_taps=int8_taps)
    name = variant_name(gate, int8_taps)
    worst = 0.0
    for out, a, b in zip(("x", "skip"), got, want):
        err, _ = max_err(a, b, torch.bfloat16,
                         ("wavenet_variant", f"wavenet_variant_{name}"))
        allowed = VARIANT_TOL[int8_taps] * (1 + b.float().abs().max().item())
        print(f"variant {name} {what} {out}: "
              f"max_abs_err {err:.3e} (allowed {allowed:.3e}), mean "
              f"{(a.float() - b.float()).abs().mean().item():.3e}")
        if err > allowed:
            raise AssertionError(
                f"variant_stack {gate} int8={int8_taps} disagrees on {out}")
        worst = max(worst, err)
    return worst


def check_quantiser(x: torch.Tensor, s: float) -> int:
    """The int8 body's quantiser against the plain one on x (bf16
    as stored, and the f32 values), bit for bit; also on the rounding
    borders k + 1/2 and past +-127. Returns the words compared."""
    from parallelwavegan_torch.ops.cuda.wavenet_variant import (
        quantize_words,
        quantize_words_reference,
    )

    borders = torch.arange(-520, 520, device=x.device) / 4 / s
    n = 0
    for v in (x, x.float(), borders.float().reshape(-1, 4)):
        got = quantize_words(v, s)
        torch.cuda.synchronize()
        if not torch.equal(got, quantize_words_reference(v, s)):
            raise AssertionError(f"quantised {v.dtype} words differ from "
                                 f"the plain quantiser")
        n += got.numel()
    return n


def check_variant_kernel(dev) -> float:
    """B4 against its plain version at small shapes: the three variants
    (the product gate on at most 3 layers, where it stays finite), ragged
    T, T below a tile, dilations past T. Returns the largest error."""
    rng = np.random.default_rng(11)
    cases = [  # (B, T, dilations)
        (2, 1000, (1, 2, 4)), (3, 333, (1, 8, 64)), (1, 7, (1, 2)),
        (1, 130, (512, 1)), (2, 4133, tuple(2 ** i for i in range(10))),
    ]
    worst = 0.0
    for B, T, dils in cases:
        w, x, c = variant_inputs(rng, B, T, len(dils), dev)
        for gate, int8_taps in VARIANTS:
            if gate == "mul" and len(dils) > 3:
                continue
            worst = max(worst, check_variant(
                f"B={B} T={T} L={len(dils)} max_d={max(dils)}", x, c, w,
                dils, gate, int8_taps))
    return worst


def variant_bound_ms(B, T, L, int8_taps: bool) -> tuple:
    """Least time for a variant_stack call: the tap product at the int8 or
    the bf16 peak and the aux and skip|out products at the bf16 peak, vs
    bytes (x and c in and x out in bf16, skip out in f32, weights)."""
    R, G, S, A = 64, 128, 64, 80
    rows = B * T * L
    tap_flops = 2 * 3 * R * G * rows
    rest_flops = 2 * (A * G + R * (S + R)) * rows
    t_ops = (tap_flops / PEAK_FLOPS[torch.int8 if int8_taps
                                    else torch.bfloat16]
             + rest_flops / PEAK_FLOPS[torch.bfloat16])
    weights = L * (3 * R * G * (1 if int8_taps else 2)
                   + (A * G + R * (S + R)) * 2 + (G + S + R) * 4)
    nbytes = B * T * ((2 * R + A) * 2 + S * 4) + weights
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# the tool's metric of each variant
VARIANT_METRICS = {"bf16_tanh": "wavenet_variant_bf16_ms",
                   "bf16_mul": "wavenet_no_transcendental_bound_ms",
                   "int8_taps": "wavenet_int8_taps_ms"}


def variant_phase(dev, smi: str) -> dict:
    """Step 7 of the module docstring: the experiment tool at its full
    shape (the counted run of the variant kernel's path), then every
    variant held against its plain version at that shape (the product gate
    on its first 3 layers), its quantiser bit for bit, the plain version
    timed, and each variant's plan, bound and per-layer byte floor."""
    from parallelwavegan_torch.ops.cuda.wavenet_variant import (
        quantize_taps,
        variant_launch_plan,
        variant_stack,
        variant_stack_reference,
    )
    from parallelwavegan_torch.tools import int8_wavenet_experiment as tool

    torch.cuda.synchronize()
    variant_stack.launches = 0
    t0 = time.perf_counter()
    results = tool.main(["--batch", str(BENCH_BATCH), "--frames",
                         str(BENCH_FRAMES)])
    torch.cuda.synchronize()
    out = {"launches": variant_stack.launches,
           "tool": {r["metric"]: r["value"] for r in results},
           "snr_db": {r["metric"]: r["vs_baseline"] for r in results}}
    print(f"int8_wavenet_experiment: {time.perf_counter() - t0:.1f} s wall, "
          f"variant_stack launches {out['launches']}")
    for r in results:
        if not np.isfinite(r["value"]) or r["value"] <= 0:
            raise AssertionError(f"bad time for {r['metric']}")
    snr = out["snr_db"]
    # the bf16 variant reproduces the baseline's math; int8 taps cost SNR
    # but must keep the signal
    if abs(snr["wavenet_variant_bf16_ms"]
           - snr["wavenet_bf16_baseline_ms"]) > 1.0 \
            or not snr["wavenet_int8_taps_ms"] > 20.0:
        raise AssertionError(f"unexpected SNR {snr}")

    B, T, L = BENCH_BATCH, BENCH_FRAMES * HOP, tool.LAYERS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dils = tuple(2 ** i for i in range(L))
    w, x, c = variant_inputs(np.random.default_rng(12), B, T, L, dev)
    out["err"] = 0.0
    with torch.inference_mode():
        for gate, int8_taps in VARIANTS:
            n = 3 if gate == "mul" else L
            wn = {k: v[:n].contiguous() for k, v in w.items()}
            out["err"] = max(out["err"], check_variant(
                f"at the tool's shape B={B} T={T} L={n}", x, c, wn, dils[:n],
                gate, int8_taps))
        s_tap = torch.ones((L, 2), device=dev)
        out["plain_ms"] = time_ms(
            lambda: variant_stack_reference(x, c, w, s_tap, dils), reps=2)
        _, s_tap = quantize_taps(w["w_tap"], 4.0)
        out["quantised_words"] = check_quantiser(x[:2].contiguous(),
                                                 float(s_tap[0, 0]))
    print(f"int8 quantiser: {out['quantised_words']} words "
          f"bit-equal to the plain quantiser")
    bytes_floor = layer_bytes_floor_ms(B, T, L, torch.bfloat16)
    t = out["tool"]
    out["variants"] = {}
    for gate, int8_taps in VARIANTS:
        name = variant_name(gate, int8_taps)
        bound, by = variant_bound_ms(B, T, L, int8_taps)
        out["variants"][name] = v = {
            "plan": variant_launch_plan(B, T, 80, L, gate, int8_taps, sms),
            "ms": t[VARIANT_METRICS[name]], "bound_ms": bound,
            "bound_by": by, "bytes_floor_ms": bytes_floor,
            "max_rel_err": REL_ERR[f"wavenet_variant_{name}"]}
        print(f"variant_stack {name} {B} x {T}, {L} layers: {v['ms']:.2f} ms "
              f"on the {v['plan']['body']} body ({v['ms'] / bytes_floor:.2f} "
              f"x the per-layer byte floor {bytes_floor:.2f} ms; bound "
              f"{bound:.2f} ms by {by}); max_rel_err {v['max_rel_err']:.3e}; "
              f"plan {v['plan']} on {smi}")
    out["tanh_over_baseline"] = (t["wavenet_variant_bf16_ms"]
                                 / t["wavenet_bf16_baseline_ms"])
    print(f"variant_stack {B} x {T}, {L} layers: serving kernel on the same "
          f"layers {t['wavenet_bf16_baseline_ms']:.2f} ms, bf16 tanh "
          f"variant {out['tanh_over_baseline']:.3f} x that; plain bf16 tanh "
          f"{out['plain_ms']:.2f} ms on {smi}")
    out["bound_ms"] = out["variants"]["bf16_tanh"]["bound_ms"]
    out["bound_by"] = out["variants"]["bf16_tanh"]["bound_by"]
    return out


def hifigan_training_phase(dev, smi: str) -> dict:
    """Step 8 of the module docstring. No hand-written kernel is on this
    path (the JAX train step fuses only Parallel WaveGAN). Returns the step
    times and the peak memory."""
    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.utils.model_loader import load_model

    rng = np.random.default_rng(2)
    f32_config = dict(HIFIGAN_V1_TRAIN, mixed_precision=False,
                      **HIFIGAN_V1_TRAIN_CUT)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_corpus(dump, rng, n_utts=16)
        # four f32 steps: nothing at step 0 (the gates are strict), D alone
        # at step 1, G + adv + D at steps 2 and 3, then one evaluation
        initial, _, _, _, _ = init_train_state(f32_config, seed=0, device=dev)
        u0 = initial.extra_d["msd.discriminators_0.layer_0.u"].clone()
        n_g = sum(p.numel() for p in initial.generator.parameters())
        n_d = sum(p.numel() for p in initial.discriminator.parameters())
        del initial
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = run(f32_config, dump, dump, os.path.join(tmp, "exp"),
                      seed=0, device="cuda", dump_config=False)
        torch.cuda.synchronize()
        print(f"hifigan training f32 {f32_config['batch_size']} x "
              f"{f32_config['batch_max_steps']} samples, G {n_g / 1e6:.2f} M "
              f"and D {n_d / 1e6:.2f} M parameters: {trainer.steps} steps in "
              f"{time.perf_counter() - t0:.1f} s wall (first calls)")
        state = trainer.state
        if trainer.steps != 4 or trainer.device.type != "cuda" \
                or state.opt_g.count != 2 or state.opt_d.count != 3:
            raise AssertionError("the trainer did not take 4 steps on cuda")
        check_trainer(trainer, "hifigan training f32", HIFIGAN_LOSS_NAMES)
        u = state.extra_d["msd.discriminators_0.layer_0.u"]
        moved = (u - u0).abs().max().item()
        print(f"  u of msd.discriminators_0.layer_0 moved by {moved:.3e} "
              f"(|u| = {u.norm().item():.4f})")
        if not moved > 1e-4 or not torch.isfinite(u).all():
            raise AssertionError("the spectral-norm vector did not advance")
        path = os.path.join(tmp, "exp", "checkpoint-4steps.ckpt")
        print(f"  {os.path.basename(path)} "
              f"({os.path.getsize(path) / 1e6:.1f} MB)")

        # two more steps as the recipe runs them, in mixed precision,
        # resumed from that checkpoint (parameters, u, EMA, optimizers)
        mixed_config = dict(HIFIGAN_V1_TRAIN, train_max_steps=6,
                            save_interval_steps=6, eval_interval_steps=1000,
                            log_interval_steps=2)
        mixed = run(mixed_config, dump, dump, os.path.join(tmp, "exp_mixed"),
                    resume=path, seed=0, device="cuda", dump_config=False)
        torch.cuda.synchronize()
        print(f"hifigan training mixed precision: steps 4 -> {mixed.steps}")
        if mixed.steps != 6 or mixed.state.opt_g.count != 4 \
                or mixed.state.opt_d.count != 5:
            raise AssertionError("the resumed run did not take 2 steps")
        check_trainer(mixed, "hifigan training mixed", HIFIGAN_LOSS_NAMES)
        for tensors in (mixed.state.params_g, mixed.state.params_d,
                        mixed.state.extra_d, mixed.state.ema_g):
            if any(t.dtype != torch.float32 or not torch.isfinite(t).all()
                   for t in tensors.values()):
                raise AssertionError("master state left finite float32")

        # one more step of each: the EMA must land one decay step from the
        # updated parameters; then the step times
        batch = mixed._to_device(next(iter(mixed.train_loader)))
        for what, t in (("f32", trainer), ("mixed", mixed)):
            step = t.train_step_factory(True, True, True)
            before = {k: v.clone() for k, v in t.state.ema_g.items()}
            step(t.state, batch)
            worst = 0.0
            for key, p in t.state.params_g.items():
                want = 0.999 * before[key] + 0.001 * p.detach()
                worst = max(worst, (t.state.ema_g[key] - want).abs().max()
                            .item())
                if torch.equal(t.state.ema_g[key], p.detach()):
                    raise AssertionError(f"ema_g equals params_g on {key}")
            print(f"  {what}: ema_g is 0.999 ema_g + 0.001 params_g to "
                  f"{worst:.2e}")
            if not worst <= 1e-6:
                raise AssertionError("the EMA step is off")
            out[f"step_ms_{what}"] = time_ms(lambda: step(t.state, batch),
                                             reps=3)
        profile_step(mixed, batch, "hifigan mixed")
        profile_step(trainer, batch, "hifigan f32")
        torch.cuda.reset_peak_memory_stats()
        mixed.train_step_factory(True, True, True)(mixed.state, batch)
        torch.cuda.synchronize()
        out["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"hifigan (G, adv, D) step {f32_config['batch_size']} x "
              f"{f32_config['batch_max_steps']}: f32 "
              f"{out['step_ms_f32']:.1f} ms "
              f"({1e3 / out['step_ms_f32']:.2f} steps/s), mixed precision "
              f"{out['step_ms_mixed']:.1f} ms "
              f"({1e3 / out['step_ms_mixed']:.2f} steps/s), peak memory "
              f"(mixed) {out['step_peak_gb']:.2f} GB on {smi}")

        # serve what was trained: the EMA weights of the resumed run's .ckpt
        final = os.path.join(tmp, "exp_mixed", "checkpoint-6steps.ckpt")
        mel = np.load(os.path.join(dump, "utt0-feats.npy"))
        waves = {}
        for use_ema in (True, False):
            model = load_model(final, mixed_config, device="cuda",
                               use_ema=use_ema)
            waves[use_ema] = model.synthesize_batch([mel])[0]
            if waves[use_ema].shape != (len(mel) * HOP, 1) \
                    or not np.isfinite(waves[use_ema]).all():
                raise AssertionError("bad waveform from the trained .ckpt")
        diff = float(np.abs(waves[True] - waves[False]).max())
        print(f"load_model({os.path.basename(final)}, use_ema=True) decoded "
              f"{len(mel)} frames on cuda; max |EMA - raw| {diff:.3e}")
        if not diff > 0:
            raise AssertionError("use_ema served the raw parameters")
    return out


def write_scp_corpus(root: str, rng: np.random.Generator, n_utts: int
                     ) -> dict:
    """Seeded utterances as 16-bit wav files and npy features, listed in a
    wav.scp and a feats.scp; returns them as bin.train's split dict."""
    from parallelwavegan_torch.utils.io import write_wav

    os.makedirs(root)
    wav_lines, feats_lines = [], []
    for i in range(n_utts):
        frames = 72 + 4 * (i % 8)  # longer than the 64-frame window
        t = np.arange(frames * HOP) / SR
        wave = sum(0.2 / (k + 1) * np.sin(2 * np.pi * (90 + 7 * i) * (k + 1)
                                          * t) for k in range(3))
        wave = wave + 0.01 * rng.standard_normal(t.shape)
        wav = os.path.join(root, f"utt{i}.wav")
        feats = os.path.join(root, f"utt{i}-feats.npy")
        write_wav(wav, wave, SR)
        np.save(feats, rng.standard_normal((frames, 80)).astype(np.float32))
        wav_lines.append(f"utt{i} {wav}")
        feats_lines.append(f"utt{i} {feats}")
    split = {"wav_scp": os.path.join(root, "wav.scp"),
             "feats_scp": os.path.join(root, "feats.scp")}
    for key, lines in (("wav_scp", wav_lines), ("feats_scp", feats_lines)):
        with open(split[key], "w") as f:
            f.write("\n".join(lines) + "\n")
    return split


def check_moved(what: str, module, start, unmoved_allowed: int) -> None:
    """Every parameter of ``module`` finite, all but ``unmoved_allowed`` of
    them changed from ``start``'s."""
    before = dict(start.named_parameters())
    still = [k for k, p in module.named_parameters()
             if torch.equal(p, before[k])]
    moved = len(before) - len(still)
    finite = all(torch.isfinite(p).all() for p in module.parameters())
    print(f"  {what}: {moved} of {len(before)} parameters changed"
          + (f" (not: {', '.join(still[:6])}{' ...' if len(still) > 6 else ''})"
             if still else ""))
    if moved < len(before) - unmoved_allowed or not finite:
        raise AssertionError(f"{what} parameters did not train")


POWER_FLOOR = 1e-7  # the STFT losses' power clamp (ops/spectral.py)


def kinked_stft(loss, x, y, kinks: dict, key: str):
    """(sc, mag) of the multi-resolution STFT loss ``loss`` for x against y
    ((B, T) or (B, C, T)), written out with its two kinks, the power clamp
    of each magnitude and the sign of log |Y| - log |X|, taken from
    ``kinks[key]`` where the gradient gate's reference route decided them
    (decided and stored on the first call). The f32 routes then differ by
    their arithmetic, not by the side of a kink rounding puts a bin on, as
    the VQ-VAE's routes share float64's codes. The loss is continuous at
    its kinks: its value is held to ``loss``'s."""
    from parallelwavegan_torch.ops.spectral import stft_magnitude

    if x.dim() == 3:
        x, y = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
    decided = kinks.setdefault(key, [])
    floor = POWER_FLOOR ** 0.5
    sc = mag = 0.0
    for i, res in enumerate(zip(loss.fft_sizes, loss.hop_sizes,
                                loss.win_lengths)):
        X, Y = (stft_magnitude(v, *res, loss.window, power_clamp_min=1e-30,
                               method=loss.method) for v in (x, y))
        if len(decided) == i:
            decided.append([(m.detach() ** 2 > POWER_FLOOR).cpu()
                            for m in (X, Y)])
        keep_x, keep_y = (t.to(X.device) for t in decided[i][:2])
        d = torch.log(torch.where(keep_y, Y, floor)) - torch.log(
            torch.where(keep_x, X, floor))
        if len(decided[i]) == 2:
            decided[i].append(torch.sign(d.detach()).cpu())
        sc = sc + torch.linalg.vector_norm(
            torch.where(keep_y, Y, floor) - torch.where(keep_x, X, floor)
        ) / torch.linalg.vector_norm(torch.where(keep_y, Y, floor))
        mag = mag + torch.mean(decided[i][2].to(d) * d)
    n = len(loss.fft_sizes)
    with torch.no_grad():
        want = sum(loss(x, y)).item()
    got = (sc / n + mag / n).item()
    if not abs(got - want) <= 1e-5 * abs(want):
        raise AssertionError(f"{key}: the gate's STFT loss {got} is not the "
                             f"step's {want}")
    return sc / n, mag / n


def kinked_feature_match(loss, feats_hat, feats, kinks: dict, key: str):
    """The feature-matching loss ``loss`` with the sign of each |f_hat -
    f| taken from ``kinks[key]`` as ``kinked_stft`` takes its kinks; its
    value held to ``loss``'s."""
    signs = kinks.setdefault(key, [])
    total, j = 0.0, 0
    for hats, reals in zip(feats_hat, feats):
        if not loss.include_final_outputs:
            hats, reals = hats[:-1], reals[:-1]
        disc = 0.0
        for f_hat, f in zip(hats, reals):
            d = f_hat - f.detach()
            if len(signs) == j:
                signs.append(torch.sign(d.detach()).cpu())
            disc = disc + torch.mean(signs[j].to(d) * d)
            j += 1
        total = total + (disc / len(hats) if loss.average_by_layers
                         else disc)
    if loss.average_by_discriminators:
        total = total / len(feats_hat)
    with torch.no_grad():
        want = loss(feats_hat, feats).item()
    if not abs(total.item() - want) <= 1e-5 * abs(want):
        raise AssertionError(f"{key}: the gate's feature matching "
                             f"{total.item()} is not the step's {want}")
    return total


def gate_routes(gen, dis, b: dict) -> dict:
    """The gradient gate's routes (G, D, batch): the card's modules in f32
    (k), copies on the CPU in f32 (p) and in float64 (e); the batch's
    integer tensors stay integers."""
    def cpu(t, dtype=None):
        return t.cpu() if dtype is None or not t.is_floating_point() \
            else t.cpu().to(dtype)

    return {"k": (gen, dis, b),
            "p": (copy.deepcopy(gen).cpu(), copy.deepcopy(dis).cpu(),
                  {k: cpu(v) for k, v in b.items()}),
            "e": (copy.deepcopy(gen).cpu().double(),
                  copy.deepcopy(dis).cpu().double(),
                  {k: cpu(v, torch.float64) for k, v in b.items()})}


class _DecidedLeakyReLU:
    """A LeakyReLU (or a ReLU, slope 0) of G or D in the gate: its branch
    (input > 0) is the
    sign pattern that the first route to reach this call recorded in
    ``state["decided"][state["key"]]`` (float64: ``gate_gradients`` runs
    it first), so that a pre-activation within rounding of 0 takes one
    slope on every route."""

    def __init__(self, slope: float, state: dict):
        self.slope, self.state = slope, state

    def __call__(self, x):
        st = self.state
        masks = st["decided"].setdefault(st["key"], [])
        i = st["i"]
        st["i"] = i + 1
        if i == len(masks):
            masks.append((x.detach() > 0).cpu())
        return torch.where(masks[i].to(x.device), x, x * self.slope)


class _DecidedDiscriminator:
    """A route's discriminator (or generator) with its LeakyReLUs' and
    ReLUs' branches decided by float64: ``at(name)`` is the discriminator
    as the
    loss term ``name`` calls it, its n-th call keyed (name, n);
    ``keyed(name)`` keys the module's next forward (name,) wherever it is
    called from; ``restore`` puts the module's own activations back. The
    activations held in an ``act`` attribute are decided; one called
    inside a forward (``F.leaky_relu``) stays the route's."""

    def __init__(self, dis, decided: dict):
        self.dis = dis
        self.state = {"decided": decided, "key": None, "i": 0}
        self.saved = []
        for m in dis.modules():
            act = getattr(m, "act", None)
            if getattr(act, "func", None) is F.leaky_relu:
                slope = act.keywords["negative_slope"]
            elif act is F.relu:
                slope = 0.0
            else:
                continue
            self.saved.append((m, act))
            m.act = _DecidedLeakyReLU(slope, self.state)

    def at(self, name: str):
        calls = iter(range(1 << 30))

        def call(*args, **kwargs):
            self.state.update(key=(name, next(calls)), i=0)
            return self.dis(*args, **kwargs)

        return call

    def keyed(self, name: str) -> None:
        self.state.update(key=(name,), i=0)

    def restore(self) -> None:
        for m, act in self.saved:
            m.act = act


def gate_gradients(routes: dict, forward, terms: dict, d_loss) -> dict:
    """Per route of ``gate_routes``: G's outputs (``outs``), G's loss (the
    sum of ``terms``) and its parameters' gradients through the route's own
    forward and loss (``own``), and float64's at the route's outputs
    (``own_ref``: float64's loss and network, G's outputs swapped for the
    route's); each term's cotangents at float64's outputs of G (``cot``:
    the loss's backward alone, through D into G's outputs, term by term);
    G's gradients through the route's network on float64's cotangents
    (``held``: the network's backward alone); D's loss on the route's own
    prediction and its parameters' gradients (``d``). The loss's kinks
    (``kinked_stft``, ``kinked_feature_match``) and the branches of D's
    LeakyReLUs (``_DecidedDiscriminator``, each D call of each term keyed
    by its order) and of G's LeakyReLUs and ReLUs (each forward keyed
    alike) are decided once, by float64 at its outputs: an input within
    rounding of a kink would otherwise take another slope on each route,
    and one term of an ill-conditioned sum, a bias gradient of D, then
    parts the routes by up to 2.5 a; in G a frame of the duration trunk's
    32 into its input conv's weight gradient, 9.5 a, and a token of the
    duration predictor's ReLUs into the token table's, 1.3 a (ROADMAP
    C-4). forward(G, b) -> G's
    outputs (a tuple); term(outs, D, b, kinks) and d_loss(outs, D, b) -> a
    loss."""
    decided = {}  # G's and D's branches, by float64
    dis_of = {r: _DecidedDiscriminator(dis, decided)
              for r, (_, dis, _) in routes.items()}
    gen_of = {r: _DecidedDiscriminator(gen, decided)
              for r, (gen, _, _) in routes.items()}

    def g_forward(r, b):
        gen_of[r].keyed("generator")
        return forward(routes[r][0], b)

    def g_loss(outs, r, b):
        return sum(term(outs, dis_of[r].at(name), b, kinks)
                   for name, term in terms.items())

    be = routes["e"][2]
    kinks = {}  # decided on float64, at its outputs
    try:
        with torch.no_grad():
            outs_e = g_forward("e", be)
            g_loss(outs_e, "e", be)
            d_loss(list(outs_e), dis_of["e"].at("d_loss"), be)
        cots = {}
        for r, (_, _, b) in routes.items():
            leaves = [o.detach().to(b["y"].device, b["y"].dtype)
                      .requires_grad_() for o in outs_e]
            cots[r] = {}
            for name, term in terms.items():
                for i, c in enumerate(torch.autograd.grad(
                        term(leaves, dis_of[r].at(name), b, kinks), leaves,
                        allow_unused=True)):
                    if c is not None:
                        cots[r][f"{name} at output {i}"] = c
        held_cot = [sum(c for key, c in cots["e"].items()
                        if key.endswith(f"output {i}")) for i in range(
                            len(outs_e))]
        got, graph_e = {}, None
        for r in "ekp":  # float64 first: its graph gives each route's
            gen, dis, b = routes[r]  # reference at that route's outputs
            names = [n for n, _ in gen.named_parameters()]
            params = list(gen.parameters())
            outs = g_forward(r, b)
            loss_g = g_loss(outs, r, b)
            own = torch.autograd.grad(loss_g, params, retain_graph=True)
            held = torch.autograd.grad(outs, params, [
                c.to(o.device, o.dtype) for c, o in zip(held_cot, outs)],
                retain_graph=r == "e")
            if r == "e":
                graph_e, own_ref = (outs, params), own
            else:  # float64's gradient at this route's own outputs: its
                # loss's cotangents there, through float64's network
                at = [o.detach().to(be["y"].device, be["y"].dtype)
                      .requires_grad_() for o in outs]
                cot_at = torch.autograd.grad(g_loss(at, "e", be), at,
                                             allow_unused=True)
                own_ref = torch.autograd.grad(graph_e[0], graph_e[1], [
                    torch.zeros_like(o) if c is None else c
                    for c, o in zip(cot_at, graph_e[0])], retain_graph=True)
            loss_d = d_loss([o.detach() for o in outs],
                            dis_of[r].at("d_loss"), b)
            grads_d = torch.autograd.grad(loss_d, list(dis.parameters()))
            got[r] = {"loss_g": loss_g.item(), "loss_d": loss_d.item(),
                      "outs": [o.detach().cpu() for o in outs],
                      "own": {n: t.cpu() for n, t in zip(names, own)},
                      "own_ref": {n: t for n, t in zip(names, own_ref)},
                      "cot": {k: t.cpu() for k, t in cots[r].items()},
                      "held": {n: t.cpu() for n, t in zip(names, held)},
                      "d": {n: t.cpu() for (n, _), t in zip(
                          dis.named_parameters(), grads_d)}}
    finally:
        for wrapped in (*dis_of.values(), *gen_of.values()):
            wrapped.restore()
    return got


def hold_gate(tag: str, got: dict, T: int, B: int = 2) -> dict:
    """G's outputs on the card held to float64 (``float64_gate``), then
    ``gradient_gate`` on each set of ``gate_gradients``: G's own
    gradients, each route's held to float64's gradient at that route's own
    outputs (the loss's curvature would otherwise turn each route's forward
    rounding into a gradient difference, and one ill-conditioned sum, the
    output conv's bias, part the card from float64 by up to 1.5 a where
    the plain route lay 0.5 a from it); the loss's cotangents at G's
    outputs; G's gradients on float64's cotangents; D's gradients. G's and
    D's losses within max(2 |p - e|, 1e-4 |e|) of float64 on the card.
    Every set is printed (G's own gradients also against float64 at its
    own outputs, for reference, not a gate) before the first failure is
    raised. Returns the gates."""
    from parallelwavegan_torch.tools.float64_check import gradient_gate

    out, failed = {}, []
    for i, (k, p, e) in enumerate(zip(*(got[r]["outs"] for r in "kpe"))):
        float64_gate(f"{tag} generator output {i} on {B} x {T}", k, p, e)
    try:
        ratio = gradient_gate(*(got[r]["own"] for r in "kpe"))["gate"]
        ratio = f"{ratio[0]:.3f} (on {ratio[1]})"
    except AssertionError as err:
        ratio = f"past 1: {err}"
    print(f"{tag} generator gradient against float64 at float64's outputs "
          f"(not a gate): |k - e| / max(2 |p - e|, a) {ratio}")
    for key, what in (
            ("own", "generator gradient (float64 at each route's outputs)"),
            ("cot", "generator loss's cotangent at G's outputs"),
            ("held", "generator gradient on float64's cotangents"),
            ("d", "discriminator gradient")):
        refs = ({"grads_e_p": got["p"]["own_ref"]} if key == "own" else {})
        try:
            gate = gradient_gate(
                got["k"][key], got["p"][key],
                got["k"]["own_ref"] if key == "own" else got["e"][key],
                what=f"{tag} {what}", **refs)
        except AssertionError as err:
            print(f"FAILED: {err}")
            failed.append(err)
            continue
        print(f"{tag} {what} on {B} x {T}, {gate['parameters']} tensors in "
              f"allowances a: k - p {gate['kp'][0]:.3f} (on "
              f"{gate['kp'][1]}), p - e {gate['pe'][0]:.3f} "
              f"({gate['plain_outside']} outside a), k - e "
              f"{gate['ke'][0]:.3f}, gate |k - e| / max(2 |p - e|, a) "
              f"{gate['gate'][0]:.3f} (on {gate['gate'][1]}): within")
        out[f"{key}_gate"] = gate["gate"][0]
    for what, loss in (("generator", "loss_g"), ("discriminator", "loss_d")):
        losses = {r: got[r][loss] for r in got}
        err = abs(losses["k"] - losses["e"])
        print(f"{tag} {what} loss: card {losses['k']:.6f}, CPU f32 "
              f"{losses['p']:.6f}, float64 {losses['e']:.6f}")
        if not err <= max(2 * abs(losses["p"] - losses["e"]),
                          1e-4 * abs(losses["e"])):
            raise AssertionError(f"{tag} {what} loss on the card lies "
                                 f"{err:.3e} from float64")
    if failed:
        raise failed[0]
    return out


# the discriminators' pooling settings (kernel, stride, padding,
# count_include_pad): the multi-scale MelGAN discriminator's, and the
# HiFi-GAN multi-scale discriminator's as the UHiFiGAN and HiFi-GAN
# recipes set it (scale_downsample_pooling_params)
POOLINGS = ((4, 2, 1, False), (4, 2, 2, True))


def check_pooling_backward(dev) -> dict:
    """The discriminators' pooling (``POOLINGS``) on the card: the input
    gradient of ``ops.conv.avg_pool1d`` and of ``F.avg_pool1d`` against
    float64, on a channels-last input and a transposed (B, C, T) one. The
    port's must lie at most 2 x the CPU's f32 + 1e-6 (of 1 + max) from
    float64; ``F.avg_pool1d``'s is printed (its CUDA backward is what the
    port's replaces, ROADMAP.md C-3)."""
    from parallelwavegan_torch.ops.conv import avg_pool1d
    from parallelwavegan_torch.tools.float64_check import rel_err

    g = torch.Generator().manual_seed(21)
    out = {}
    for k, stride, pad, include in POOLINGS:
        def library(x):
            return F.avg_pool1d(x.transpose(1, 2), k, stride, pad,
                                count_include_pad=include).transpose(1, 2)

        frames = (16384 + 2 * pad - k) // stride + 1
        setting = (f"kernel {k}, stride {stride}, padding {pad}, "
                   f"count_include_pad {include}")
        for layout in ("channels-last", "from (B, C, T)"):
            x0 = torch.randn((2, 16384, 16), generator=g)
            cot = torch.randn((2, frames, 16), generator=g)
            errs = {}
            for name, fn in (("port", avg_pool1d), ("library", library)):
                got = {}
                for r, (device, dtype) in (("k", (dev, torch.float32)),
                                           ("p", ("cpu", torch.float32)),
                                           ("e", ("cpu", torch.float64))):
                    x = x0.to(device, dtype)
                    if layout != "channels-last":
                        x = x.transpose(1, 2).contiguous().transpose(1, 2)
                    x.requires_grad_()
                    y = (fn(x, k, stride, pad, include) if fn is avg_pool1d
                         else fn(x))
                    (dx,) = torch.autograd.grad(y, x, cot.to(device, dtype))
                    got[r] = dx.cpu()
                errs[name] = {r: rel_err(got[r], got["e"]) for r in "kp"}
            print(f"pooling backward ({setting}) at 2 x 16,384 x 16, "
                  f"{layout}: the port's avg_pool1d "
                  f"{errs['port']['k']:.3e} of 1 + max from float64 on the "
                  f"card, F.avg_pool1d {errs['library']['k']:.3e} (CPU f32 "
                  f"{errs['port']['p']:.3e})")
            if not errs["port"]["k"] <= 2 * errs["port"]["p"] + 1e-6:
                raise AssertionError(f"avg_pool1d's backward ({setting}) on "
                                     f"the card lies far from float64")
            out[f"{setting}, {layout}"] = errs
    return out


def gate_window(b: dict, n: int) -> dict:
    """Step 6's gate input n of a PWG v1 loader batch: GATE_BATCH of its
    windows (the n-th group of them, cycling) cut to GATE_SAMPLES samples
    at the n-th such offset, and the mel frames that condition them (with
    the aux context on both sides)."""
    ctx = PWG_V1["generator_params"]["aux_context_window"]
    frames = GATE_SAMPLES // HOP
    groups = TRAIN_BATCH // GATE_BATCH
    rows = slice(GATE_BATCH * (n % groups), GATE_BATCH * (n % groups + 1))
    t0 = n * GATE_SAMPLES % (TRAIN_SAMPLES - GATE_SAMPLES + 1)
    f0 = t0 // HOP
    return {k: v[rows, f0:f0 + frames + 2 * ctx] if k == "c"
            else v[rows, t0:t0 + GATE_SAMPLES] for k, v in b.items()}


def pwg_gate_losses(crit):
    """(forward, terms, d_loss) of PWG v1's gate (step 6): G on the fused
    training path (B1/B2 on the card, their plain versions on the CPU),
    the multi-resolution STFT loss and lambda_adv x the adversarial loss
    as the step forms them, and the discriminator loss on the
    prediction."""
    def stft(outs, dis, b, kinks):
        sc, mag = kinked_stft(crit["stft"], outs[0][..., 0], b["y"][..., 0],
                              kinks, "stft")
        return sc + mag

    def adversarial(outs, dis, b, kinks):
        return PWG_V1["lambda_adv"] * crit["gen_adv"](dis(outs[0]))

    def d_loss(outs, dis, b):
        real, fake = crit["dis_adv"](dis(outs[0]), dis(b["y"]))
        return real + fake

    def forward(gen, b):
        return (gen(b["z"], b["c"], fused=True, trainable=True),)

    return forward, {"stft": stft, "adversarial": adversarial}, d_loss


def mb_melgan_gate_losses(crit):
    """(forward, terms, d_loss) of the multi-band recipe's gate: the terms
    of the (G, adv) generator loss as the step forms it (PQMF synthesis;
    full-band STFT loss halved, half the subband loss, 2.5 x the
    adversarial loss) and the discriminator loss on the prediction."""
    pqmf = crit["pqmf"]

    def stft(outs, dis, b, kinks):
        sc, mag = kinked_stft(crit["stft"], pqmf.synthesis(outs[0])[..., 0],
                              b["y"][..., 0], kinks, "stft")
        return 0.5 * (sc + mag)

    def subband_stft(outs, dis, b, kinks):
        sc, mag = kinked_stft(crit["sub_stft"], outs[0].transpose(1, 2),
                              pqmf.analysis(b["y"]).transpose(1, 2), kinks,
                              "subband stft")
        return 0.5 * (sc + mag)

    def adversarial(outs, dis, b, kinks):
        return MB_MELGAN_V2_TRAIN["lambda_adv"] * crit["gen_adv"](
            dis(pqmf.synthesis(outs[0])))

    terms = {"stft": stft, "subband stft": subband_stft,
             "adversarial": adversarial}

    def d_loss(outs, dis, b):
        real, fake = crit["dis_adv"](dis(pqmf.synthesis(outs[0])),
                                     dis(b["y"]))
        return real + fake

    return (lambda gen, b: (gen(b["c"]),)), terms, d_loss


def melgan_training_phase(dev, smi: str) -> dict:
    """Step 10 (a), (b) and (d) of the module docstring: multi-band MelGAN
    v2 trained at full width from a wav.scp + feats.scp, its gradients held
    to float64, the trained generator served. No hand-written kernel is on
    this path (the JAX step fuses only Parallel WaveGAN). Returns step
    times and the gradient gates."""
    from parallelwavegan_torch.bin.train import VERSION, run
    from parallelwavegan_torch.engine import checkpoint as ckpt
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.utils.model_loader import load_model

    rng = np.random.default_rng(4)
    config = dict(MB_MELGAN_V2_TRAIN, **MB_MELGAN_V2_TRAIN_CUT)
    B, T = config["batch_size"], config["batch_max_steps"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        split = write_scp_corpus(os.path.join(tmp, "corpus"), rng, B)
        # (a) four f32 steps: nothing at step 0 (the gates are strict), G
        # alone at steps 1 and 2, G + adv + D at step 3, one evaluation
        initial, _, _, _, _ = init_train_state(config, seed=0, device=dev)
        n_g = sum(p.numel() for p in initial.generator.parameters())
        n_d = sum(p.numel() for p in initial.discriminator.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = run(config, split, split, os.path.join(tmp, "exp"),
                      seed=0, device="cuda", dump_config=False)
        torch.cuda.synchronize()
        print(f"mb-melgan training f32 {B} x {T} samples from a wav.scp + "
              f"feats.scp, G {n_g / 1e6:.2f} M and D {n_d / 1e6:.2f} M "
              f"parameters: {trainer.steps} steps in "
              f"{time.perf_counter() - t0:.1f} s wall (first calls)")
        state = trainer.state
        if trainer.steps != 4 or trainer.device.type != "cuda" \
                or state.opt_g.count != 3 or state.opt_d.count != 1:
            raise AssertionError("the trainer did not take 4 steps on cuda")
        check_trainer(trainer, "mb-melgan training f32", MB_MELGAN_LOSS_NAMES)
        check_moved("G", trainer.generator, initial.generator, 0)
        check_moved("D", trainer.discriminator, initial.discriminator, 0)
        path = os.path.join(tmp, "exp", "checkpoint-4steps.ckpt")
        ckpt.load_checkpoint(path, initial)
        for module, loaded in ((trainer.generator, initial.generator),
                               (trainer.discriminator, initial.discriminator)):
            want = dict(module.named_parameters())
            for key, p in loaded.named_parameters():
                if not torch.equal(p, want[key]):
                    raise AssertionError(f".ckpt differs on {key}")
        print(f"  {os.path.basename(path)} "
              f"({os.path.getsize(path) / 1e6:.1f} MB) loads back")
        del initial

        # two more steps in mixed precision, resumed from that checkpoint
        mixed_config = dict(config, mixed_precision=True, train_max_steps=6,
                            save_interval_steps=6, eval_interval_steps=1000)
        mixed = run(mixed_config, split, split,
                    os.path.join(tmp, "exp_mixed"), resume=path, seed=0,
                    device="cuda", dump_config=False)
        torch.cuda.synchronize()
        print(f"mb-melgan training mixed precision: steps 4 -> "
              f"{mixed.steps}")
        if mixed.steps != 6 or mixed.state.opt_g.count != 5 \
                or mixed.state.opt_d.count != 3:
            raise AssertionError("the resumed run did not take 2 steps")
        check_trainer(mixed, "mb-melgan training mixed",
                      MB_MELGAN_LOSS_NAMES)
        if any(p.dtype != torch.float32 or not torch.isfinite(p).all()
               for p in mixed.generator.parameters()):
            raise AssertionError("master parameters left finite float32")

        # step times and where the device time goes, both precisions
        batch = mixed._to_device(next(iter(mixed.train_loader)))
        for what, t in (("f32", trainer), ("mixed", mixed)):
            step = t.train_step_factory(True, True, True)
            out[f"step_ms_{what}"] = time_ms(lambda: step(t.state, batch),
                                             reps=3)
        profile_step(trainer, batch, "mb-melgan f32")
        profile_step(mixed, batch, "mb-melgan mixed")
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step_factory(True, True, True)(trainer.state, batch)
        torch.cuda.synchronize()
        out["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"mb-melgan (G, adv, D) step {B} x {T}: f32 "
              f"{out['step_ms_f32']:.1f} ms "
              f"({1e3 / out['step_ms_f32']:.2f} steps/s), mixed precision "
              f"{out['step_ms_mixed']:.1f} ms "
              f"({1e3 / out['step_ms_mixed']:.2f} steps/s), peak memory "
              f"(f32) {out['step_peak_gb']:.2f} GB on {smi}")

        # (b) the generator and discriminator loss and every gradient on
        # the loader's batch cut to 2 x 16,384: on the card in f32 (k), on
        # the CPU in f32 (p) and in float64 (e), each held to float64
        # (gate_gradients, hold_gate)
        b = {k: v[:2] for k, v in batch.items()}
        got = gate_gradients(
            gate_routes(trainer.generator, trainer.discriminator, b),
            *mb_melgan_gate_losses(trainer.criterion))
        out.update(hold_gate("mb-melgan", got, T))
        del got
        out["pooling"] = check_pooling_backward(dev)

        # (d) serve what was trained: the resumed run's last .ckpt through
        # a .gckpt and load_model with PQMF, the card against the CPU
        final = os.path.join(tmp, "exp_mixed", "checkpoint-6steps.ckpt")
        served, _, _, _, _ = init_train_state(mixed_config, seed=1,
                                              device="cpu")
        ckpt.load_checkpoint(final, served)
        gckpt = os.path.join(tmp, "generator.gckpt")
        ckpt.save_generator_checkpoint(gckpt, served)
        written = dict(MB_MELGAN_V2_TRAIN, version=VERSION)
        mel = rng.standard_normal((200, 80)).astype(np.float32)
        waves = {}
        for device in ("cuda", "cpu"):
            model = load_model(gckpt, written, device=device)
            if model.pqmf is None:
                raise AssertionError("the trained multi-band model has no "
                                     "PQMF")
            waves[device] = model.synthesize_batch([mel])[0]
        if waves["cuda"].shape != (200 * HOP, 1):
            raise AssertionError("bad waveform from the trained generator")
        err, allowed = max_err(torch.from_numpy(waves["cuda"]),
                               torch.from_numpy(waves["cpu"]), torch.float32)
        print(f"mb-melgan (d) the trained generator served by load_model on "
              f"cuda, 1 x 200 frames: max_abs_err {err:.3e} against the CPU "
              f"(allowed {allowed:.3e}; max |y| "
              f"{np.abs(waves['cpu']).max():.3f})")
        if err > allowed:
            raise AssertionError("the served multi-band MelGAN disagrees")
        print(f"mb-melgan PQMF: trained with {trainer.criterion['pqmf']}, "
              f"served with {model.pqmf} (version {VERSION} reads as <= "
              f"0.4.2, as in the JAX package)")
    return out


def pwg_v3_training_phase(dev, smi: str) -> dict:
    """Step 10 (c): Parallel WaveGAN v3 trained at its batch on the
    per-layer path. Its kernel size 5 lies outside the fused WaveNet stack,
    in the JAX step as here: the step with the yaml's settings refuses the
    fused path on the card, and the run launches neither stack kernel."""
    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.step import make_generator_forward
    from parallelwavegan_torch.ops.cuda.pwg_infer import (
        unsupported_fused_settings,
    )
    from parallelwavegan_torch.ops.cuda.wavenet_stack import wavenet_stack
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        wavenet_stack_backward,
    )

    rng = np.random.default_rng(5)
    config = dict(PWG_V3_TRAIN, **PWG_V3_TRAIN_CUT)
    B, T = config["batch_size"], config["batch_max_steps"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_corpus(dump, rng, n_utts=B)
        initial, gen, _, _, _ = init_train_state(config, seed=0, device=dev)
        bad = unsupported_fused_settings(gen)
        try:
            make_generator_forward(PWG_V3_TRAIN, gen)
        except NotImplementedError as e:
            print(f"pwg v3: the fused stack does not take {bad}: {e}")
        else:
            raise AssertionError("the fused path took kernel size 5")
        if bad != ["kernel_size=5"]:
            raise AssertionError(f"unexpected fused-path verdict {bad}")
        torch.cuda.synchronize()
        wavenet_stack.launches = wavenet_stack_backward.launches = 0
        t0 = time.perf_counter()
        trainer = run(config, dump, dump, os.path.join(tmp, "exp"), seed=0,
                      device="cuda", dump_config=False)
        torch.cuda.synchronize()
        out["fwd_launches"] = wavenet_stack.launches
        out["bwd_launches"] = wavenet_stack_backward.launches
        print(f"pwg v3 training f32 {B} x {T} samples: {trainer.steps} steps "
              f"in {time.perf_counter() - t0:.1f} s wall (first calls); "
              f"wavenet_stack launches {out['fwd_launches']}, backward "
              f"launches {out['bwd_launches']} (the plan: none, the "
              f"per-layer path)")
        if trainer.steps != 3 or trainer.state.opt_g.count != 2 \
                or trainer.state.opt_d.count != 2:
            raise AssertionError("the trainer did not take 3 steps on cuda")
        if out["fwd_launches"] or out["bwd_launches"]:
            raise AssertionError("a stack kernel ran on kernel size 5")
        check_trainer(trainer, "pwg v3 training f32",
                      LOSS_NAMES + ("feature_matching_loss",))
        # the last layer's residual 1x1 (v, g, bias) feeds nothing, and
        # first_conv's kernel_v has a zero gradient but for rounding
        check_moved("G", trainer.generator, initial.generator, 4)
        # RAdam's first steps move a parameter by lr x its first moment:
        # at lr 5e-5 under a gradient norm clipped to 1 many of the
        # discriminator's fall below their f32 rounding
        n_d = len(list(trainer.discriminator.parameters()))
        check_moved("D", trainer.discriminator, initial.discriminator,
                    n_d - 1)
        batch = trainer._to_device(next(iter(trainer.train_loader)))
        step = trainer.train_step_factory(True, True, True)
        out["step_ms_f32"] = time_ms(lambda: step(trainer.state, batch),
                                     reps=2)
        profile_step(trainer, batch, "pwg v3 f32")
        print(f"pwg v3 (G, adv, D) step {B} x {T}: f32 "
              f"{out['step_ms_f32']:.1f} ms on {smi}")
    return out


def mrf_bound_ms(rows, C, kernels, n_layers, mm_dtype, x_item) -> tuple:
    """Least time for one MRF stage: 2 * 2 * n_layers * sum(k) * C^2
    operations per row at the matmul type's peak vs x read once, the output
    written once and the weights read once at the memory rate."""
    flops = 2.0 * rows * 2 * n_layers * sum(kernels) * C * C
    w_item = torch.empty((), dtype=mm_dtype).element_size()
    nbytes = 2.0 * rows * C * x_item + (
        2 * n_layers * sum(kernels) * C * C * w_item
        + len(kernels) * 2 * n_layers * 3 * C * 4)
    t_ops, t_bytes = flops / PEAK_FLOPS[mm_dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def wave_diff(what: str, got, want, max_allowed: float) -> float:
    """Largest |got - want| over a list of waveforms (full scale 1.0)."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"{what}: bad waveform")
        worst = max(worst, float(np.abs(a - b).max()))
    print(f"{what}: max |waveform difference| {worst:.3e} "
          f"(allowed {max_allowed:.1e} of a full scale of 1)")
    if worst > max_allowed:
        raise AssertionError(f"{what} disagrees")
    return worst


def stage_launches(model, stages, B, frames) -> int:
    """What the plans of a HiFi-GAN's MRF stages routed to the fused
    kernel launch for a batch of B mels of ``frames`` frames."""
    from parallelwavegan_torch.ops.cuda.mrf_stage import mrf_stage_plan

    gen = model.generator
    kernels = tuple(gen.resblock_kernel_sizes)
    dils = tuple(gen.resblock_dilations[0])
    total, T = 0, frames
    for i, s_up in enumerate(gen.upsample_scales):
        T *= s_up
        if i in stages:
            pack = model._mrf_packs[i]
            total += mrf_stage_plan(B, T, pack["w0"].shape[-1], kernels,
                                    dils, pack["w0"].dtype)["launches"]
    return total


def hifigan_phase(dev, smi: str, pool) -> dict:
    """Step 2h of the module docstring. Returns what the kernels line needs
    for mrf_stage, and the pending host scores."""
    from parallelwavegan_torch.ops.cuda.mrf_stage import (
        mrf_stage,
        mrf_stage_plan,
        mrf_stage_reference,
    )
    from parallelwavegan_torch.ops.hifigan_infer import mrf_chain_stage
    from parallelwavegan_torch.utils.model_loader import load_model

    with open(QUALITY_REFERENCE) as f:
        reference = json.load(f)
    files = [os.path.join(ASSET_DIR, name)
             for name in reference["batch_files"]]
    if sorted(files) != sorted(glob.glob(os.path.join(ASSET_DIR,
                                                      "*-feats.npy"))):
        raise AssertionError("the reference does not list the asset's mels")
    mels = [np.load(f) for f in files]
    names = [os.path.basename(f)[: -len("-feats.npy")] for f in files]
    scored = [names.index(f"eval_utt{i}") for i in range(N_SCORED)]
    calib = [mels[names.index(f"eval_utt{i}")] for i in range(N_CALIB)]
    ckpt = os.path.join(ASSET_DIR, "generator.gckpt")
    out = {}

    # (a) f32, exact mode: all 24 utterances in one bucketed batch, as the
    # reference file was made; the first N_SCORED are scored on the host
    model = load_model(ckpt, HIFIGAN_V1, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    exact = model.synthesize_batch(mels)
    wall = time.perf_counter() - t0
    for w, m in zip(exact, mels):
        if w.shape != (len(m) * HOP, 1) or not np.isfinite(w).all():
            raise AssertionError("bad f32 waveform")
    print(f"hifigan (a) f32 exact, {len(mels)} utterances, "
          f"{sum(len(m) for m in mels)} frames: synthesize_batch "
          f"{wall * 1e3:.1f} ms wall (first call)")
    sr = HIFIGAN_V1["sampling_rate"]
    out["scores"] = [
        pool.submit(score_utterance,
                    (names[i], exact[i][:, 0], files[i].replace(
                        "-feats.npy", "-gt.wav"), sr, True))
        for i in scored]

    # (b) the fused MRF kernel in f32 against (a): f32 sums in another
    # order through 72 convs; 1e-4 of full scale
    bucket = -(-max(len(m) for m in mels) // 64) * 64
    mrf_stage.launches = 0
    model.use_mrf_kernel(quant=False)
    t0 = time.perf_counter()
    fused = model.synthesize_batch(mels)
    wall = time.perf_counter() - t0
    launches = mrf_stage.launches
    print(f"hifigan (b) f32, use_mrf_kernel(quant=False): synthesize_batch "
          f"{wall * 1e3:.1f} ms wall, mrf_stage launches {launches}")
    want_launches = stage_launches(model, range(4), len(mels), bucket)
    if launches != want_launches:
        raise AssertionError(f"the plans of four f32 stages launch "
                             f"{want_launches} times, not {launches}")
    wave_diff("hifigan (b) kernel f32 vs exact", fused, exact, 1e-4)
    # a stage subset: stages 2 and 3 on the kernel, 0 and 1 on cuDNN
    mrf_stage.launches = 0
    model.use_mrf_kernel(quant=False, stages=[2, 3])
    subset = model.synthesize_batch(mels[:2])
    want_launches = stage_launches(
        model, (2, 3), 2, -(-max(len(m) for m in mels[:2]) // 64) * 64)
    if mrf_stage.launches != want_launches:
        raise AssertionError(f"stages 2, 3 launch {want_launches} times")
    want = load_model(ckpt, HIFIGAN_V1, device="cuda").synthesize_batch(
        mels[:2])
    wave_diff("hifigan (b) kernel on stages 2, 3 vs exact", subset, want, 1e-4)

    # (c) int8 packs against the int8 conv chain on the MRF keys, scales
    # calibrated on the same utterances. The chain divides by sx where the
    # kernel multiplies by 1/sx, so a value on a rounding border may land
    # on the neighbouring int8 step (with the chain's rounding the two are
    # bit-equal: tests/test_torch_hifigan_serving.py). So the tolerance is
    # in waveform units, 5e-2 of full scale at the worst sample, and the
    # mean difference is held to a tenth of the int8 mode's own distance
    # from the exact mode
    model.use_mrf_kernel(quant=True, calib_mels=calib)
    fused_q = model.synthesize_batch(mels)
    chain = load_model(ckpt, HIFIGAN_V1, device="cuda")
    chain.quantize_int8(calib, schedule="all")
    chain._int8_scales = {k: v for k, v in chain._int8_scales.items()
                          if not k.endswith("_up")}
    chain_q = chain.synthesize_batch(mels)
    out["int8_flip_err"] = wave_diff(
        "hifigan (c) kernel int8 vs int8 conv chain", fused_q, chain_q, 5e-2)
    mean_abs = float(np.mean([np.abs(a - b).mean()
                              for a, b in zip(fused_q, chain_q)]))
    quant_noise = float(np.mean([np.abs(a - b).mean()
                                 for a, b in zip(chain_q, exact)]))
    # how rare such a border case is, at the first MRF conv's input
    with torch.inference_mode():
        gen = chain.generator
        c = chain._calibration_batch(calib)
        x = F.leaky_relu(gen.upsamples[0](gen.act(gen.input_conv(c))), 0.1)
        sx = chain._int8_weights["s0_b0_l0_c1"][2]
        flips = (torch.round(x / sx).clamp(-127, 127)
                 != torch.round(x * (1.0 / sx)).clamp(-127, 127))
        rate = flips.float().mean().item()
    print(f"  mean |difference| {mean_abs:.3e}, against {quant_noise:.3e} "
          f"between the int8 chain and the f32 exact mode; x / sx and "
          f"x * (1 / sx) round apart on {rate:.2e} of {flips.numel()} "
          f"inputs of the first MRF conv")
    if mean_abs > 0.1 * quant_noise or rate > 1e-4:
        raise AssertionError("int8 kernel and int8 chain differ by more "
                             "than border cases explain")
    out["int8_scores"] = [
        pool.submit(score_utterance,
                    (names[i], fused_q[i][:, 0], files[i].replace(
                        "-feats.npy", "-gt.wav"), sr, False))
        for i in scored]
    del model, chain, fused, fused_q, chain_q, subset, want

    # (d) the timed shape: batch 32 x 512 frames, bf16; mels cut and tiled
    # from the asset's utterances
    frames = np.concatenate(mels)
    need = BENCH_BATCH * BENCH_FRAMES
    frames = np.tile(frames, (-(-need // len(frames)), 1))[:need]
    bench_mels = list(frames.reshape(BENCH_BATCH, BENCH_FRAMES, -1))
    audio_s = BENCH_BATCH * BENCH_FRAMES * HOP / SR
    model = load_model(ckpt, HIFIGAN_V1, dtype=torch.bfloat16, device="cuda")
    gen = model.generator

    def forward_ms(what: str) -> float:
        fn, (c, z), _ = model.prepare_batch(bench_mels)
        y = fn(c, z)
        if y.shape != (BENCH_BATCH, BENCH_FRAMES * HOP, 1) \
                or not torch.isfinite(y.float()).all():
            raise AssertionError(f"bad bf16 output in mode {what}")
        ms = time_ms(lambda: fn(c, z), reps=3)
        print(f"hifigan (d) bf16 {BENCH_BATCH} x {BENCH_FRAMES} frames, "
              f"{what}: forward {ms:.2f} ms, "
              f"{audio_s / (ms / 1e3):.1f} audio-s/s on {smi}")
        return ms

    out["exact_ms"] = forward_ms("exact (cuDNN)")
    model.quantize_int8(calib, schedule="auto")
    out["chain_auto_ms"] = forward_ms("int8 conv chain, schedule auto")
    model.quantize_int8(calib, schedule="all")
    out["chain_all_ms"] = forward_ms("int8 conv chain, schedule all")
    model._int8_scales = model._int8_weights = None
    model.use_mrf_kernel(quant=True, calib_mels=calib)
    packs_q = model._mrf_packs
    out["kernel_int8_ms"] = forward_ms("mrf_stage kernel, int8 packs")
    # the counted run of this path: one forward on bf16 packs
    model.use_mrf_kernel(quant=False)
    packs = model._mrf_packs
    torch.cuda.synchronize()
    mrf_stage.launches = 0
    waves = model.synthesize_batch(bench_mels)
    torch.cuda.synchronize()
    out["launches"] = mrf_stage.launches
    want_launches = stage_launches(model, range(4), BENCH_BATCH, BENCH_FRAMES)
    print(f"hifigan (d) main path, bf16 packs: mrf_stage launches "
          f"{out['launches']} (the stages' plans: {want_launches})")
    if out["launches"] != want_launches or not all(
            w.shape == (BENCH_FRAMES * HOP, 1) and np.isfinite(w).all()
            for w in waves):
        raise AssertionError("the bf16 main path did not run the kernel")
    out["kernel_bf16_ms"] = forward_ms("mrf_stage kernel, bf16 packs")

    # every stage at the main path's shapes and weights: the kernel in both
    # modes against its plain version, timed beside it and beside the
    # exact forward's own conv chain of the same stage (mrf_chain_stage,
    # cuDNN: the library's version of the stage)
    kernels = tuple(gen.resblock_kernel_sizes)
    dils = tuple(gen.resblock_dilations[0])
    slope = gen.nonlinear_activation_params.get("negative_slope", 0.1)
    _, (c, _), _ = model.prepare_batch(bench_mels)
    totals = dict.fromkeys(("ms", "int8_ms", "plain_ms", "library_ms",
                            "bound_ms", "int8_bound_ms"), 0.0)
    out["err"], out["stages"] = 0.0, []
    with torch.inference_mode():
        from parallelwavegan_torch.ops.conv import conv1d

        x = conv1d(c, gen.input_conv.folded_kernel(), gen.input_conv.bias,
                   padding=(gen.kernel_size - 1) // 2)
        for i, up in enumerate(gen.upsamples):
            # x as the forward holds it, (B, C, T) memory seen as (B, T, C),
            # for the conv chain; the kernel takes it contiguous in (B, T,
            # C), a copy the kernel mode's forward makes too
            x = up(gen.act(x))
            xk = x.contiguous()

            def chain_stage():
                return mrf_chain_stage(gen, i, x, slope)

            rows, C = x.shape[0] * x.shape[1], x.shape[2]
            row = {"stage": i, "C": C, "T": x.shape[1]}
            for mode, pk in (("bf16", packs[i]), ("int8", packs_q[i])):
                row[f"{mode}_plan"] = mrf_stage_plan(
                    x.shape[0], x.shape[1], C, kernels, dils, pk["w0"].dtype)
                print(f"  stage {i} plan, {mode} packs: "
                      f"{row[f'{mode}_plan']}")
            for mode, pk, quant in (("bf16", packs[i], False),
                                    ("int8", packs_q[i], True)):
                got = mrf_stage(xk, pk, kernels=kernels, dils=dils,
                                quant=quant)
                ref = mrf_stage_reference(xk, pk, kernels=kernels, dils=dils,
                                          quant=quant)
                # the trained stages grow from |x| ~ 10 to ~ 1e8: the error
                # relative to the largest value is the one to read
                err = check(f"mrf_stage at the main-path shape, stage {i} "
                            f"C={C} {mode} packs", got, ref, torch.bfloat16,
                            "mrf_stage")
                out["err"] = max(out["err"], err)
                del got, ref
                key = "ms" if mode == "bf16" else "int8_ms"
                mrf_stage.launches = 0
                row[key] = time_ms(
                    lambda: mrf_stage(xk, pk, kernels=kernels, dils=dils,
                                      quant=quant), reps=3)
                if mrf_stage.launches != 4 * row[f"{mode}_plan"]["launches"]:
                    raise AssertionError("the stage did not launch its plan")
                bkey = "bound_ms" if mode == "bf16" else "int8_bound_ms"
                row[bkey], row["bound_by"] = mrf_bound_ms(
                    rows, C, kernels, len(dils), pk["w0"].dtype, 2)
            row["plain_ms"] = time_ms(
                lambda: mrf_stage_reference(xk, packs[i], kernels=kernels,
                                            dils=dils, quant=False), reps=2)
            # the median of 5 single calls: one call in a run can take
            # several times the others
            each = sorted(time_each_ms(chain_stage, reps=5))
            row["library_ms"] = each[len(each) // 2]
            row["library_spread_ms"] = [each[0], each[-1]]
            for key in totals:
                totals[key] += row[key]
            out["stages"].append(row)
            print(f"  stage {i} C={C} T={x.shape[1]}: kernel bf16 "
                  f"{row['ms']:.2f} ms, int8 {row['int8_ms']:.2f} ms; plain "
                  f"{row['plain_ms']:.2f} ms; the forward's cuDNN chain "
                  f"{row['library_ms']:.2f} ms (median of 5, {each[0]:.2f} "
                  f"to {each[-1]:.2f}); bound bf16 {row['bound_ms']:.2f} ms, "
                  f"int8 {row['int8_bound_ms']:.2f} ms by {row['bound_by']}")
            x = chain_stage()
    out.update(totals)
    out["bound_by"] = out["stages"][0]["bound_by"]
    print(f"mrf_stage, four stages at {BENCH_BATCH} x {BENCH_FRAMES} frames: "
          f"kernel bf16 {out['ms']:.2f} ms, int8 {out['int8_ms']:.2f} ms, "
          f"plain {out['plain_ms']:.2f} ms, the forward's cuDNN chain "
          f"{out['library_ms']:.2f} ms (the whole exact forward "
          f"{out['exact_ms']:.2f} ms), bound {out['bound_ms']:.2f} ms "
          f"(int8 {out['int8_bound_ms']:.2f} ms) on {smi}")
    if out["library_ms"] > out["exact_ms"]:
        raise AssertionError("the stages' conv chains take longer than the "
                             "exact forward that runs them")
    del model, x, xk, c
    return out


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph and the graph replayed, so the host's launch path drops out (the
    kernels of a product of tens of microseconds can finish faster than
    the host launches them)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=3) / reps


def matmul_phase(dev, smi: str) -> dict:
    """The stage roofline tool, whose matmul measurements launch
    matmul_bench (the counted run of that kernel's path) and which then
    times one stage in its four modes; then matmul_bench at its five
    shapes, int8 (and bf16 beside it): kernel, plain version, the single
    PyTorch call, and the bound; kernel and library both as back-to-back
    launches and as graph replays (device time alone). These products take
    tens of microseconds, so this runs after the host scoring has ended."""
    from parallelwavegan_torch.ops.cuda.matmul_bench import (
        MRF_SHAPES,
        matmul_bench,
        matmul_bench_reference,
    )
    from parallelwavegan_torch.tools import int8_stage_roofline
    from parallelwavegan_torch.tools.int8_stage_roofline import (
        library_matmul,
        matmul_bound_ms,
        matmul_inputs,
    )

    torch.cuda.synchronize()
    matmul_bench.launches = 0
    int8_stage_roofline.main(["--matmuls", "--stages", "3"])
    out = {f"{mode}_{key}": 0.0 for mode in ("int8", "bf16")
           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "graph_ms", "library_graph_ms")}
    out["launches"] = matmul_bench.launches
    print(f"int8_stage_roofline: matmul_bench launches {out['launches']}")
    for mode in ("int8", "bf16"):
        nbytes = 0
        for M, K, N in MRF_SHAPES:
            a, b = matmul_inputs(M, K, N, mode, dev)
            ms = time_ms(lambda: matmul_bench(a, b), reps=50, warmup=2)
            plain = time_ms(lambda: matmul_bench_reference(a, b), reps=5)
            lib = time_ms(lambda: library_matmul(a, b), reps=50, warmup=2)
            g_ms = graph_ms(lambda: matmul_bench(a, b))
            g_lib = graph_ms(lambda: library_matmul(a, b))
            bound, by = matmul_bound_ms(M, K, N, mode)
            moved = (M * K + K * N) * a.element_size() + M * N * 4
            nbytes += moved
            print(f"matmul_bench {mode} M={M} K={K} N={N}: kernel "
                  f"{ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, library "
                  f"{lib * 1e3:.1f} us; graph replay: kernel "
                  f"{g_ms * 1e3:.1f} us = {moved / g_ms / 1e6:.0f} GB/s, "
                  f"library {g_lib * 1e3:.1f} us; bound {bound * 1e3:.1f} "
                  f"us by {by}")
            for key, value in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", bound),
                               ("graph_ms", g_ms),
                               ("library_graph_ms", g_lib)):
                out[f"{mode}_{key}"] += value
            out["bound_by"] = by
        out[f"{mode}_gb_per_s"] = nbytes / out[f"{mode}_graph_ms"] / 1e6
    for mode, lib in (("int8", "torch._int_mm"), ("bf16", "torch.matmul")):
        print(f"matmul_bench, five shapes {mode}: kernel "
              f"{out[mode + '_ms']:.4f} ms ({lib} {out[mode + '_library_ms']:.4f}"
              f" ms); graph replay: kernel {out[mode + '_graph_ms']:.4f} ms "
              f"= {out[mode + '_gb_per_s']:.0f} GB/s ({lib} "
              f"{out[mode + '_library_graph_ms']:.4f} ms); bound "
              f"{out[mode + '_bound_ms']:.4f} ms on {smi}")
    return out


def check_quality(hifi: dict) -> None:
    """Wait for the host scores of (a) and (c) and hold (a) to the
    committed per-utterance reference of the JAX package."""
    with open(QUALITY_REFERENCE) as f:
        reference = json.load(f)
    got = dict(job.result(timeout=900) for job in hifi["scores"])
    int8 = dict(job.result(timeout=900) for job in hifi["int8_scores"])
    for name, scores in got.items():
        want = reference["utterances"][name]
        for key, tol in QUALITY_TOL.items():
            if not abs(scores[key] - want[key]) <= tol:
                raise AssertionError(
                    f"{name} {key}: {scores[key]:.4f}, reference "
                    f"{want[key]:.4f}")
    line = []
    for key, tol in QUALITY_TOL.items():
        mean = float(np.mean([s[key] for s in got.values()]))
        want = float(np.mean([reference["utterances"][n][key] for n in got]))
        line.append(f"{key} {mean:.4f} (reference {want:.4f}, all "
                    f"{len(reference['utterances'])} utterances "
                    f"{reference['mean'][key]:.4f})")
        if not abs(mean - want) <= tol:
            raise AssertionError(f"mean {key} {mean} vs reference {want}")
    print(f"hifigan (a) quality, first {len(got)} utterances scored, each "
          f"within {QUALITY_TOL} of the CPU reference: " + "; ".join(line))
    mcd8 = float(np.mean([s["mcd"] for s in int8.values()]))
    print(f"hifigan (c) quality, kernel with int8 packs, the same "
          f"{len(int8)} utterances: mcd {mcd8:.4f}")
    if not mcd8 < 1.25 * float(np.mean([s["mcd"] for s in got.values()])):
        raise AssertionError("the int8 kernel path lost the voice")


def serving_timing(model, mels, dtype, sms: int, smi: str) -> dict:
    """Step 4 for one dtype: the PWG forward and the stack kernel at the
    bench shape (CUDA events), the kernel held against its plain version
    on the forward's own stack inputs, its plan, bound and byte floor."""
    from parallelwavegan_torch.ops.cuda.pwg_infer import _conv1x1
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        stack_launch_plan,
        wavenet_stack,
        wavenet_stack_reference,
    )

    fn, (c, z), _ = model.prepare_batch(mels)
    out = {"forward_ms": time_ms(lambda: fn(c, z), reps=3)}
    gen = model.generator
    with torch.inference_mode():
        c_up = gen.upsample_net(c).contiguous()
        x0 = _conv1x1(gen.first_conv, z).contiguous()
        w, dils = model.stack_params, gen.dilations
        xo, sk = wavenet_stack(x0, c_up, w, dils)
        xo_p, sk_p = wavenet_stack_reference(x0, c_up, w, dils)
        errs = [max_err(a, b, dtype, "wavenet_stack") for a, b in
                ((xo, xo_p), (sk, sk_p))]
        del xo, sk, xo_p, sk_p
        out["ms"] = time_ms(lambda: wavenet_stack(x0, c_up, w, dils), reps=3)
        out["plain_ms"] = time_ms(
            lambda: wavenet_stack_reference(x0, c_up, w, dils), reps=2)
    name = str(dtype)[6:]
    for what, (err, allowed) in zip(("x", "skip"), errs):
        print(f"stack at main-path shape {name} {what}: max_abs_err "
              f"{err:.3e} (allowed {allowed:.3e})")
        if err > allowed:
            raise AssertionError(f"wavenet_stack disagrees on {what}")
    out["err"] = max(e for e, _ in errs)
    B, T = x0.shape[:2]
    L = len(dils)
    plan = stack_launch_plan(B, T, c_up.shape[-1], L, dtype, sms)
    out["plan"] = plan
    out["bound_ms"], out["bound_by"] = stack_bound_ms(B, T, L, dtype,
                                                      plan["body"])
    out["bytes_floor_ms"] = layer_bytes_floor_ms(B, T, L, dtype)
    out["tflop_per_s"] = stack_flops(B, T, L) / out["ms"] / 1e9
    audio_s = BENCH_BATCH * BENCH_FRAMES * HOP / SR
    print(f"forward {name} {BENCH_BATCH} x {BENCH_FRAMES} frames: "
          f"{out['forward_ms']:.2f} ms, "
          f"{audio_s / (out['forward_ms'] / 1e3):.1f} audio-s/s; "
          f"wavenet_stack {out['ms']:.2f} ms = {out['tflop_per_s']:.1f} "
          f"TFLOP/s on the {plan['body']} body, {plan['launches']} launches "
          f"of {plan['blocks']} blocks (plain {out['plain_ms']:.2f} ms, "
          f"bound {out['bound_ms']:.2f} ms by {out['bound_by']}, "
          f"per-layer-launch byte floor {out['bytes_floor_ms']:.2f} ms) on "
          f"{smi}")
    return out


def seeded_melgan(config: dict, seed: int):
    """A MelGAN generator of ``config`` with seeded weights: the module's
    N(0, 0.02) kernels rescaled to a per-entry std of 1 / sqrt(K Cin), so
    that the waveform reaches a full-scale level (at N(0, 0.02) the
    full-band v1's sits near 1e-6, where no tolerance tells right from
    wrong)."""
    from parallelwavegan_torch.models import MelGANGenerator

    gen = MelGANGenerator(**config["generator_params"],
                          generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("kernel"):
                p.mul_(1.0 / (0.02 * (p.shape[0] * p.shape[1]) ** 0.5))
    return gen.eval()


def asset_mels() -> tuple:
    """The asset's 24 evaluation mels and their names, in file order."""
    files = sorted(glob.glob(os.path.join(ASSET_DIR, "*-feats.npy")))
    return ([np.load(f) for f in files],
            [os.path.basename(f)[: -len("-feats.npy")] for f in files])


def float64_gate(what: str, card, cpu32, cpu64) -> float:
    """Hold the card's output to float64: |card - e| <= 2 |cpu32 - e| +
    1e-6, e the CPU's float64 forward. Returns the card's error."""
    card, cpu32 = card.double().cpu(), cpu32.double()
    if not torch.isfinite(card).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (card - cpu64).abs().max().item()
    ref = (cpu32 - cpu64).abs().max().item()
    print(f"{what}: max |card - float64| {err:.3e}, CPU f32 {ref:.3e} "
          f"(allowed {2 * ref + 1e-6:.3e}; max |y| "
          f"{cpu64.abs().max().item():.3f})")
    if err > 2 * ref + 1e-6:
        raise AssertionError(f"{what}: the card lies further from float64 "
                             f"than twice the CPU's f32 forward")
    return err


def melgan_phase(smi: str) -> dict:
    """Step 9 (a)-(e) of the module docstring. Returns the f32
    multi-band model and its numbers."""
    from parallelwavegan_torch.tools.train_step_profile import device_time
    from parallelwavegan_torch.utils.model_loader import load_model
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    out = {}
    frames = np.concatenate(asset_mels()[0])
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, config in (("mb", MB_MELGAN_V2), ("v1", MELGAN_V1)):
            paths[name] = os.path.join(tmp, f"{name}-checkpoint-1steps.pkl")
            save_reference_checkpoint(
                paths[name], nested(seeded_melgan(config, 1).state_dict()),
                config, steps=1)
        mb32 = load_model(paths["mb"], MB_MELGAN_V2, device="cuda")
        mb16 = load_model(paths["mb"], MB_MELGAN_V2, dtype=torch.bfloat16,
                          device="cuda")
        mb_cpu = load_model(paths["mb"], MB_MELGAN_V2, device="cpu")
        v1 = load_model(paths["v1"], MELGAN_V1, device="cuda")
        v1_cpu = load_model(paths["v1"], MELGAN_V1, device="cpu")
    if mb32.pqmf is None or mb32.upsample_factor != HOP:
        raise AssertionError("multi-band MelGAN v2 without its PQMF")
    n_params = sum(p.numel() for p in mb32.generator.parameters())
    print(f"mb-melgan (a) v2 loaded from a reference .pkl: {n_params} "
          f"parameters, {mb32.pqmf}, upsample factor "
          f"{mb32.upsample_factor}")

    # (b) f32, batch 2 x 200 frames: the card against float64 on the CPU
    batch = [frames[i * 300: i * 300 + 200] for i in range(2)]
    fn, (c, _), _ = mb32.prepare_batch(batch, bucket_size=1)
    fn_cpu, (c_cpu, _), _ = mb_cpu.prepare_batch(batch, bucket_size=1)
    gen64 = copy.deepcopy(mb_cpu.generator).double()
    with torch.inference_mode():
        y64 = mb_cpu.pqmf.synthesis(gen64(c_cpu.double()))
    out["f64_err"] = float64_gate("mb-melgan (b) f32 2 x 200 frames",
                                  fn(c, None), fn_cpu(c_cpu, None), y64)

    # (c) batch 32 x 512 frames of the asset's mels: bf16 against f32 on
    # the card; (d) both timed, and one profiled forward of each
    need = BENCH_BATCH * BENCH_FRAMES
    tiled = np.tile(frames, (-(-need // len(frames)), 1))[:need]
    bench = list(tiled.reshape(BENCH_BATCH, BENCH_FRAMES, -1))
    audio_s = BENCH_BATCH * BENCH_FRAMES * HOP / SR
    runs = {"f32": mb32.prepare_batch(bench),
            "bf16": mb16.prepare_batch(bench)}
    y32, y16 = (fn(c, None) for fn, (c, _), _ in runs.values())
    if y32.shape != (BENCH_BATCH, BENCH_FRAMES * HOP, 1):
        raise AssertionError("bad multi-band MelGAN output shape")
    err, allowed = max_err(y16, y32, torch.bfloat16)
    print(f"mb-melgan (c) bf16 {BENCH_BATCH} x {BENCH_FRAMES} frames vs f32 "
          f"on the card: max_abs_err {err:.3e} (allowed {allowed:.3e})")
    if err > allowed:
        raise AssertionError("bf16 multi-band MelGAN disagrees with f32")
    out["bf16_err"] = err
    del y32, y16
    for name, (fn, (c, _), _) in runs.items():
        ms = time_ms(lambda: fn(c, None), reps=3)
        out[f"{name}_ms"] = ms
        print(f"mb-melgan (d) {name} {BENCH_BATCH} x {BENCH_FRAMES} frames: "
              f"forward {ms:.2f} ms, {audio_s / (ms / 1e3):.1f} audio-s/s "
              f"on {smi}")
    for name, (fn, (c, _), _) in runs.items():
        prof = device_time(lambda: fn(c, None), n=1, top=10)
        print(f"mb-melgan (d) {name} profile: {prof['profiled_wall_ms']:.1f} "
              f"ms wall, device busy {prof['device_busy_ms']:.2f} ms; by "
              f"kernel:")
        for row in prof["kernels"]:
            print(f"  {row['ms']:8.3f} ms x{row['calls']:4.0f}  "
                  f"{row['name']}")
    del runs, mb16

    # (e) full-band MelGAN v1, batch 1 x 300 frames, f32: the card against
    # its CPU forward
    fn, (c, _), _ = v1.prepare_batch([frames[:300]], bucket_size=1)
    fn_cpu, (c_cpu, _), _ = v1_cpu.prepare_batch([frames[:300]],
                                                 bucket_size=1)
    want = fn_cpu(c_cpu, None)
    err, allowed = max_err(fn(c, None).cpu(), want, torch.float32)
    print(f"melgan (e) v1 f32 1 x 300 frames vs the CPU: max_abs_err "
          f"{err:.3e} (allowed {allowed:.3e}; max |y| "
          f"{want.abs().max().item():.3f})")
    if err > allowed or v1.pqmf is not None:
        raise AssertionError("full-band MelGAN on the card disagrees")
    out["model"] = mb32
    return out


def write_kaldi_ark(path: str, arrays: dict) -> list:
    """A Kaldi binary ark of float32 matrices; returns its feats.scp
    lines."""
    lines = []
    with open(path, "wb") as f:
        for utt, a in arrays.items():
            f.write(utt.encode() + b" ")
            offset = f.tell()
            f.write(b"\x00BFM \x04" + np.int32(a.shape[0]).tobytes()
                    + b"\x04" + np.int32(a.shape[1]).tobytes())
            f.write(np.ascontiguousarray(a, np.float32).tobytes())
            lines.append(f"{utt} {path}:{offset}")
    return lines


def pkl_decode_phase(tmp: str) -> int:
    """Step 9 (f): the shipped HiFi-GAN checkpoint exported to a reference
    .pkl (the .gckpt's kernels after its fold, under a config without
    weight norm), decoded by ``python -m parallelwavegan_torch.bin.decode``
    from a Kaldi ark feats.scp and from an npy feats.scp, beside the
    .gckpt route from the asset's directory: three processes at once.
    Returns how many of the 24 waveforms are bit-equal in all three."""
    from scipy.io import wavfile

    from parallelwavegan_torch.utils.model_loader import load_model
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    ckpt = os.path.join(ASSET_DIR, "generator.gckpt")
    folded = load_model(ckpt, HIFIGAN_V1, device="cpu").generator
    config = copy.deepcopy(HIFIGAN_V1)
    config["generator_params"]["use_weight_norm"] = False
    config["format"] = "npy"
    pkl = os.path.join(tmp, "checkpoint-60000steps.pkl")
    save_reference_checkpoint(pkl, nested(folded.state_dict()), config,
                              steps=60000)
    conf = os.path.join(tmp, "config.json")  # bin.decode reads JSON too
    with open(conf, "w") as f:
        json.dump(config, f)
    mels, names = asset_mels()
    scp = {"ark": os.path.join(tmp, "feats_ark.scp"),
           "npy": os.path.join(tmp, "feats_npy.scp")}
    with open(scp["ark"], "w") as f:
        f.write("\n".join(write_kaldi_ark(os.path.join(tmp, "feats.ark"),
                                          dict(zip(names, mels)))) + "\n")
    with open(scp["npy"], "w") as f:
        f.write("".join(f"{n} {os.path.join(ASSET_DIR, n)}-feats.npy\n"
                        for n in names))
    runs = {"gckpt": ["--dumpdir", ASSET_DIR, "--checkpoint", ckpt],
            "pkl_ark": ["--feats-scp", scp["ark"], "--checkpoint", pkl],
            "pkl_npy": ["--scp", scp["npy"], "--checkpoint", pkl]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "parallelwavegan_torch.bin.decode", *a,
         "--config", conf, "--outdir", os.path.join(tmp, k)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, a in runs.items()}
    try:
        logs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for k, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"decode ({k}) failed:\n{logs[k][-3000:]}")
    same = 0
    for n, m in zip(names, mels):
        wavs = [wavfile.read(os.path.join(tmp, k, f"{n}_gen.wav"))[1]
                for k in runs]
        if wavs[0].shape != (len(m) * HOP,) or wavs[0].dtype != np.int16:
            raise AssertionError(f"decode wrote a bad wav for {n}")
        same += all(np.array_equal(wavs[0], w) for w in wavs[1:])
    print(f"hifigan (f) the asset as a reference .pkl through bin.decode "
          f"from an ark and an npy feats.scp, beside the .gckpt route (3 "
          f"processes at once, {wall:.1f} s wall): {same} of {len(names)} "
          f"waveforms bit-equal in all three")
    if same != len(names):
        raise AssertionError("the .pkl route differs from the .gckpt route")
    return same


def stage0_window_is_exact(model, mel, window) -> None:
    """The first MRF stage of a HiFi-GAN on mrf_stage, run on one window's
    rows of the whole utterance's stage-0 input, gives the whole's rows bit
    for bit away from the window's edges."""
    from parallelwavegan_torch.ops.conv import conv1d, conv_transpose1d
    from parallelwavegan_torch.ops.cuda.mrf_stage import mrf_stage

    gen, pack = model.generator, model._mrf_packs[0]
    s_up = gen.upsample_scales[0]
    kw = dict(kernels=tuple(gen.resblock_kernel_sizes),
              dils=tuple(gen.resblock_dilations[0]), chunk=pack["chunk"],
              quant=pack["quant"], slope=0.1)
    c = torch.from_numpy(mel[None]).to("cuda", model.dtype)
    with torch.inference_mode():
        x = conv1d(c, gen.input_conv.folded_kernel().to(c.dtype),
                   gen.input_conv.bias, padding=(gen.kernel_size - 1) // 2)
        x = conv_transpose1d(
            F.leaky_relu(x, 0.1), gen.upsamples[0].folded_kernel().to(
                c.dtype), gen.upsamples[0].bias, stride=s_up,
            padding=s_up // 2 + s_up % 2, output_padding=s_up % 2)
        lo, hi = window[0] * s_up, window[1] * s_up
        margin = 200  # rows; the stage reaches 60 on each side
        x = x.contiguous()
        whole = mrf_stage(x, pack, **kw)[0, lo + margin: hi - margin]
        part = mrf_stage(x[:, lo:hi].contiguous(), pack, **kw)[
            0, margin:-margin]
    same = torch.equal(whole, part)
    print(f"chunked (g) mrf_stage on rows [{lo}, {hi}) of the whole's "
          f"stage-0 input: {'bit-equal' if same else 'NOT equal'} to the "
          f"whole's {whole.shape[0]} inner rows")
    if not same:
        raise AssertionError("mrf_stage's output depends on where the "
                             "window starts")


def chunked_phase(dev, smi: str, mb32) -> dict:
    """Step 9 (g): one long utterance (the asset's 24 mels end to end)
    through inference_chunked(chunk 256, context 64) against the whole
    utterance's forward: HiFi-GAN exact (f32), HiFi-GAN on mrf_stage with
    f32 and with bf16 packs, multi-band MelGAN (f32), and PWG v1 on
    wavenet_stack (f32) window by window on the noise a fresh generator of
    the same seed draws in window order. Each kernel's launches are counted
    over one chunked run alone."""
    from parallelwavegan_torch.engine.checkpoint import (
        save_generator_checkpoint,
    )
    from parallelwavegan_torch.models import ParallelWaveGANGenerator
    from parallelwavegan_torch.ops.cuda.mrf_stage import mrf_stage
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        stack_launch_plan,
        wavenet_stack,
    )
    from parallelwavegan_torch.utils.model_loader import (
        chunk_windows,
        load_model,
    )

    chunk, ctx = 256, 64
    long = np.concatenate(asset_mels()[0])
    windows = chunk_windows(len(long), chunk, ctx)
    out = {"frames": len(long), "windows": len(windows)}
    ckpt = os.path.join(ASSET_DIR, "generator.gckpt")

    def walls(model, **kw):
        """Whole and chunked outputs (first calls), then the wall time of a
        second call of each."""
        whole = model.inference(long, **kw)
        chunked = model.inference_chunked(long, chunk, ctx, **kw)
        t = []
        for fn in (lambda: model.inference(long, **kw),
                   lambda: model.inference_chunked(long, chunk, ctx, **kw)):
            t0 = time.perf_counter()
            fn()
            t.append(time.perf_counter() - t0)
        return whole, chunked, t

    def report(what, whole, chunked, t, tol):
        if chunked.shape != whole.shape or not np.isfinite(chunked).all():
            raise AssertionError(f"{what}: bad chunked waveform")
        err = float(np.abs(chunked - whole).max())
        allowed = tol * (1 + float(np.abs(whole).max()))
        print(f"chunked (g) {what}: {len(long)} frames in {len(windows)} "
              f"windows; max |chunked - whole| {err:.3e} (allowed "
              f"{allowed:.3e}); wall {t[1] * 1e3:.1f} ms chunked vs "
              f"{t[0] * 1e3:.1f} ms whole = {t[1] / t[0]:.3f} x on {smi}")
        if err > allowed:
            raise AssertionError(f"{what}: chunks disagree with the whole")
        return {"err": err, "chunked_ms": t[1] * 1e3,
                "whole_ms": t[0] * 1e3, "ratio": t[1] / t[0]}

    exact = load_model(ckpt, HIFIGAN_V1, device="cuda")
    out["hifigan_exact"] = report("hifigan exact f32", *walls(exact), 1e-5)
    del exact

    # HiFi-GAN with its MRF stages on mrf_stage. With f32 packs (the
    # per-conv body) the chunks are held to B3's f32 tolerance. With bf16
    # packs (the fused-pair body; the counted run) cuDNN's bf16 convs
    # around the kernel take other algorithms for a window than for the
    # whole utterance, so a rounding of the first conv moves by a bf16
    # step and the output by the bf16 path's own error: the chunks are held
    # to the bf16 tolerance, beside the cuDNN-only bf16 forward's own
    # chunked-vs-whole difference, and the kernel alone on one window's
    # stage-0 input, cut from the whole's, must give the whole's rows bit
    # for bit
    f32_kernel = load_model(ckpt, HIFIGAN_V1, device="cuda")
    f32_kernel.use_mrf_kernel(quant=False)
    out["hifigan_kernel_f32"] = report("hifigan on mrf_stage, f32 packs",
                                       *walls(f32_kernel), TOL[torch.float32])
    del f32_kernel
    cudnn16 = load_model(ckpt, HIFIGAN_V1, dtype=torch.bfloat16,
                         device="cuda")
    out["cudnn_bf16_err"] = float(np.abs(
        cudnn16.inference_chunked(long, chunk, ctx)
        - cudnn16.inference(long)).max())
    del cudnn16
    kernel = load_model(ckpt, HIFIGAN_V1, dtype=torch.bfloat16,
                        device="cuda")
    kernel.use_mrf_kernel(quant=False)
    whole = kernel.inference(long)
    torch.cuda.synchronize()
    mrf_stage.launches = 0
    counted = kernel.inference_chunked(long, chunk, ctx)
    launches = mrf_stage.launches
    want = sum(stage_launches(kernel, range(4), 1, hi - lo)
               for lo, hi, _, _ in windows)
    print(f"chunked (g) hifigan on mrf_stage, bf16 packs: {launches} "
          f"mrf_stage launches over {len(windows)} windows (the plans: "
          f"{want})")
    if launches != want or launches < 1:
        raise AssertionError("chunked HiFi-GAN did not run mrf_stage as "
                             "its plans say")
    out["mrf_launches"] = launches
    _, again, t = walls(kernel)
    if not np.array_equal(again, counted):
        raise AssertionError("chunked HiFi-GAN on mrf_stage is not "
                             "deterministic")
    print(f"chunked (g) the cuDNN-only bf16 forward: max |chunked - whole| "
          f"{out['cudnn_bf16_err']:.3e}")
    out["hifigan_kernel"] = report("hifigan on mrf_stage, bf16 packs",
                                   whole, counted, t, TOL[torch.bfloat16])
    stage0_window_is_exact(kernel, long, windows[len(windows) // 2])
    del kernel

    out["mb_melgan"] = report("mb-melgan v2 f32", *walls(mb32), 1e-5)

    gen = ParallelWaveGANGenerator(
        **PWG_V1["generator_params"], generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "generator.gckpt")
        save_generator_checkpoint(path, gen)
        pwg = load_model(path, PWG_V1, device="cuda")
    noise = lambda: torch.Generator(device=dev).manual_seed(11)  # noqa: E731
    torch.cuda.synchronize()
    wavenet_stack.launches = 0
    got = pwg.inference_chunked(long, chunk, ctx, generator=noise())
    launches = wavenet_stack.launches
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = sum(stack_launch_plan(1, (hi - lo) * HOP, PWG_V1["num_mels"],
                                 pwg.generator.layers, torch.float32,
                                 sms)["launches"]
               for lo, hi, _, _ in windows)
    print(f"chunked (g) pwg v1 f32 on wavenet_stack: {launches} launches "
          f"over {len(windows)} windows (the plans: {want})")
    if launches != want or launches < 1:
        raise AssertionError("chunked PWG did not run wavenet_stack as its "
                             "plans say")
    out["pwg_launches"] = launches
    fresh = noise()
    for lo, hi, a, b in windows:
        fn, (c, z), _ = pwg.prepare_batch([long[lo:hi]], generator=fresh,
                                          bucket_size=1)
        want = fn(c, z)[0, (a - lo) * HOP: (b - lo) * HOP].float().cpu()
        if not np.array_equal(got[a * HOP: b * HOP], want.numpy()):
            raise AssertionError(f"PWG chunk [{a}, {b}) is not the fused "
                                 f"forward of its window on its noise")
    t = []
    for fn in (lambda: pwg.inference(long, generator=noise()),
               lambda: pwg.inference_chunked(long, chunk, ctx,
                                             generator=noise())):
        t0 = time.perf_counter()
        fn()
        t.append(time.perf_counter() - t0)
    print(f"chunked (g) pwg v1 f32: each of the {len(windows)} chunks "
          f"bit-equal to the fused forward of its window on its noise; wall "
          f"{t[1] * 1e3:.1f} ms chunked vs {t[0] * 1e3:.1f} ms whole = "
          f"{t[1] / t[0]:.3f} x on {smi}")
    out["pwg"] = {"chunked_ms": t[1] * 1e3, "whole_ms": t[0] * 1e3,
                  "ratio": t[1] / t[0]}
    return out

def seeded_style_melgan(config: dict, seed: int):
    """A StyleMelGAN generator of ``config`` with seeded weights (serving
    form). The TADE convs keep torch's uniform init; the N(0, 0.02)
    kernels of the noise upsampling are rescaled to a per-entry std of
    1 / sqrt(K Cin) and the output conv's to 8 / sqrt(K Cin), so that the
    waveform reaches a full-scale level (at the module's init its largest
    sample sits near 0.03: the softmax gates over 64 channels keep every
    block's output small)."""
    from parallelwavegan_torch.models import StyleMelGANGenerator

    gen = StyleMelGANGenerator(**config["generator_params"],
                               generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("kernel") and name.startswith(
                    ("noise_upsample", "output_conv")):
                gain = 8.0 if name.startswith("output_conv") else 1.0
                p.mul_(gain / (0.02 * (p.shape[0] * p.shape[1]) ** 0.5))
    return gen.eval()


def kernel_launch_counters() -> dict:
    """The five kernels' wrappers, by the names of the kernels line."""
    from parallelwavegan_torch.ops.cuda.matmul_bench import matmul_bench
    from parallelwavegan_torch.ops.cuda.mrf_stage import mrf_stage
    from parallelwavegan_torch.ops.cuda.wavenet_stack import wavenet_stack
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        wavenet_stack_backward,
    )
    from parallelwavegan_torch.ops.cuda.wavenet_variant import variant_stack

    return {"wavenet_stack": wavenet_stack,
            "wavenet_stack_backward": wavenet_stack_backward,
            "mrf_stage": mrf_stage, "matmul_bench": matmul_bench,
            "wavenet_variant": variant_stack}


def style_melgan_serving(smi: str) -> dict:
    """Step 12 (a)-(d) of the module docstring."""
    from parallelwavegan_torch.tools.train_step_profile import device_time
    from parallelwavegan_torch.utils.model_loader import load_model
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    out = {}
    config = STYLE_MELGAN_V1
    mels = asset_mels()[0]
    frames = np.concatenate(mels)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint-1steps.pkl")
        save_reference_checkpoint(
            path, nested(seeded_style_melgan(config, 2).state_dict()),
            config, steps=1)
        m32 = load_model(path, config)
        m16 = load_model(path, config, dtype=torch.bfloat16)
        cpu = load_model(path, config, device="cpu")  # the CPU reference
    gen = m32.generator
    if m32.device.type != "cuda" or m32.upsample_factor != HOP \
            or gen.noise_upsample_factor != 88:
        raise AssertionError("StyleMelGAN v1 did not load as configured")
    n_params = sum(p.numel() for p in gen.parameters())
    print(f"style-melgan (a) v1 loaded from a reference .pkl on cuda: "
          f"{n_params} parameters, noise grid {gen.noise_upsample_factor} "
          f"frames, upsample factor {m32.upsample_factor}")

    # (b) f32, batch 2 x 200 frames (3 noise frames): the card against
    # the CPU's float64 forward on the same z (the CPU routes: references)
    batch = [frames[i * 300: i * 300 + 200] for i in range(2)]
    fn, (c, z), _ = m32.prepare_batch(batch, bucket_size=1)
    if tuple(z.shape) != (2, 3, gen.in_channels) or c.shape[1] != 3 * 88:
        raise AssertionError(f"bad noise grid: z {tuple(z.shape)}, c "
                             f"{tuple(c.shape)}")
    fn_cpu = cpu.prepare_batch(batch, bucket_size=1)[0]
    c_cpu, z_cpu = c.cpu(), z.cpu()
    gen64 = copy.deepcopy(cpu.generator).double()
    with torch.inference_mode():
        y64 = gen64(c_cpu.double(), z_cpu.double())
    out["f64_err"] = float64_gate("style-melgan (b) f32 2 x 200 frames",
                                  fn(c, z), fn_cpu(c_cpu, z_cpu), y64)
    del gen64, y64

    # (c) batch 32 x 512 frames of the asset's mels: bf16 against f32 on
    # the same z, both timed and profiled once
    need = BENCH_BATCH * BENCH_FRAMES
    tiled = np.tile(frames, (-(-need // len(frames)), 1))[:need]
    bench = list(tiled.reshape(BENCH_BATCH, BENCH_FRAMES, -1))
    audio_s = BENCH_BATCH * BENCH_FRAMES * HOP / SR
    fn32, (c32, z32), _ = m32.prepare_batch(bench)
    fn16, (c16, _), _ = m16.prepare_batch(bench)
    z16 = z32.to(torch.bfloat16)
    runs = {"f32": (fn32, c32, z32), "bf16": (fn16, c16, z16)}
    y32, y16 = fn32(c32, z32), fn16(c16, z16)
    grid = gen.noise_frames(BENCH_FRAMES) * 88
    if y32.shape != (BENCH_BATCH, grid * HOP, 1):
        raise AssertionError(f"bad StyleMelGAN output shape {y32.shape}")
    err, allowed = max_err(y16, y32, torch.bfloat16)
    print(f"style-melgan (c) bf16 {BENCH_BATCH} x {BENCH_FRAMES} frames "
          f"({grid} on the noise grid) vs f32 on the card: max_abs_err "
          f"{err:.3e} (allowed {allowed:.3e}; max |y| "
          f"{y32.abs().max().item():.3f})")
    if err > allowed:
        raise AssertionError("bf16 StyleMelGAN disagrees with f32")
    out["bf16_err"] = err
    del y32, y16
    for name, (f, cc, zz) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: f(cc, zz), reps=3)
        out[f"{name}_ms"] = ms
        out[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"style-melgan (c) {name} {BENCH_BATCH} x {BENCH_FRAMES} "
              f"frames: forward {ms:.2f} ms, {audio_s / (ms / 1e3):.1f} "
              f"audio-s/s, peak memory {out[f'{name}_peak_gb']:.2f} GB on "
              f"{smi}")
    for name, (f, cc, zz) in runs.items():
        prof = device_time(lambda: f(cc, zz), n=1, top=10)
        out[f"{name}_busy_ms"] = prof["device_busy_ms"]
        print(f"style-melgan (c) {name} profile: "
              f"{prof['profiled_wall_ms']:.1f} ms wall, device busy "
              f"{prof['device_busy_ms']:.2f} ms; by kernel:")
        for row in prof["kernels"]:
            print(f"  {row['ms']:8.3f} ms x{row['calls']:4.0f}  "
                  f"{row['name']}")
    del runs, c32, z32, c16, z16, m16

    # (d) the asset's 24 mels as one utterance through inference_chunked:
    # the card's f32 chunks against the CPU port's (the reference) on the
    # noise of one CPU generator seeded 7; the whole forward beside them
    chunk, ctx = 256, 64
    noise = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    t0 = time.perf_counter()
    chunked = m32.inference_chunked(frames, chunk, ctx, generator=noise())
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cpu.inference_chunked(frames, chunk, ctx, generator=noise())
    t_cpu = time.perf_counter() - t0
    if chunked.shape != (len(frames) * HOP, 1):
        raise AssertionError("bad chunked StyleMelGAN waveform")
    if not np.isfinite(chunked).all():
        raise AssertionError("non-finite chunked StyleMelGAN waveform")
    err = float(np.abs(chunked - want).max())
    allowed = 1e-5 * (1 + float(np.abs(want).max()))
    print(f"style-melgan (d) {len(frames)} frames in chunks of 264 with 88 "
          f"frames of context: card f32 vs the CPU port's chunks on the "
          f"same noise max_abs_err {err:.3e} (allowed {allowed:.3e}; CPU "
          f"reference {t_cpu:.1f} s)")
    if err > allowed:
        raise AssertionError("chunked StyleMelGAN on the card disagrees "
                             "with the CPU")
    m32.inference(frames, generator=noise())  # first call
    t0 = time.perf_counter()
    whole = m32.inference(frames, generator=noise())
    t = [time.perf_counter() - t0]
    t0 = time.perf_counter()
    m32.inference_chunked(frames, chunk, ctx, generator=noise())
    t.append(time.perf_counter() - t0)
    diff = float(np.abs(chunked - whole).max())
    rms = float(np.sqrt(np.mean((chunked - whole) ** 2))
                / np.sqrt(np.mean(whole ** 2)))
    print(f"style-melgan (d) chunked vs whole (instance norm over the "
          f"window): max |difference| {diff:.3e}, relative RMS {rms:.3e}; "
          f"wall {t[1] * 1e3:.1f} ms chunked (first call "
          f"{t_first * 1e3:.1f}) vs {t[0] * 1e3:.1f} ms whole = "
          f"{t[1] / t[0]:.3f} x on {smi}")
    if not (np.isfinite(whole).all() and rms < 0.5):
        raise AssertionError("chunked StyleMelGAN strays from the whole")
    out.update(chunked_err=err, chunked_vs_whole=diff, chunked_rms=rms,
               chunked_ms=t[1] * 1e3, whole_ms=t[0] * 1e3)
    return out


def style_melgan_gate_losses(crit, starts):
    """(forward, terms, d_loss) of the v1 recipe's gate: the terms of the
    (G, adv) generator loss as the step forms it (STFT loss x lambda_aux,
    lambda_adv x the adversarial loss on the fake pass's windows) and the
    discriminator loss (real, then fake windows); the batch's z and the
    three passes' window starts fixed."""
    cfg = STYLE_MELGAN_V1_TRAIN

    def stft(outs, dis, b, kinks):
        sc, mag = kinked_stft(crit["stft"], outs[0][..., 0], b["y"][..., 0],
                              kinks, "stft")
        return cfg["lambda_aux"] * (sc + mag)

    def adversarial(outs, dis, b, kinks):
        return cfg["lambda_adv"] * crit["gen_adv"](dis(outs[0], starts[0]))

    terms = {"stft": stft, "adversarial": adversarial}

    def d_loss(outs, dis, b):
        real, fake = crit["dis_adv"](dis(outs[0], starts[2]),
                                     dis(b["y"], starts[1]))
        return real + fake

    return (lambda gen, b: (gen(b["c"], b["z"]),)), terms, d_loss


def style_melgan_training(dev, smi: str) -> dict:
    """Step 12 (e) and (f) of the module docstring."""
    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine import checkpoint as ckpt
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.step import step_generator

    rng = np.random.default_rng(6)
    config = dict(STYLE_MELGAN_V1_TRAIN, **STYLE_MELGAN_V1_TRAIN_CUT)
    B, T = config["batch_size"], config["batch_max_steps"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_corpus(dump, rng, n_utts=B)
        initial, _, _, _, _ = init_train_state(config, seed=0, device=dev)
        n_g = sum(p.numel() for p in initial.generator.parameters())
        n_d = sum(p.numel() for p in initial.discriminator.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = run(config, dump, dump, os.path.join(tmp, "exp"), seed=0,
                      device="cuda", dump_config=False)
        torch.cuda.synchronize()
        print(f"style-melgan (e) training f32 {B} x {T} samples, G "
              f"{n_g / 1e6:.2f} M and D {n_d / 1e6:.2f} M parameters: "
              f"{trainer.steps} steps in {time.perf_counter() - t0:.1f} s "
              f"wall (first calls)")
        state = trainer.state
        if trainer.steps != 3 or trainer.device.type != "cuda" \
                or state.opt_g.count != 2 or state.opt_d.count != 2:
            raise AssertionError("the trainer did not take 3 steps on cuda")
        check_trainer(trainer, "style-melgan (e) training f32", LOSS_NAMES)
        check_moved("G", trainer.generator, initial.generator, 0)
        check_moved("D", trainer.discriminator, initial.discriminator, 0)
        path = os.path.join(tmp, "exp", "checkpoint-3steps.ckpt")
        ckpt.load_checkpoint(path, initial)
        for module, loaded in ((trainer.generator, initial.generator),
                               (trainer.discriminator, initial.discriminator)):
            want = dict(module.named_parameters())
            for key, p in loaded.named_parameters():
                if not torch.equal(p, want[key]):
                    raise AssertionError(f".ckpt differs on {key}")
        print(f"  {os.path.basename(path)} "
              f"({os.path.getsize(path) / 1e6:.1f} MB) loads back")
        del initial

        mixed_config = dict(config, mixed_precision=True, train_max_steps=5,
                            save_interval_steps=5, eval_interval_steps=5)
        mixed = run(mixed_config, dump, dump, os.path.join(tmp, "mixed"),
                    resume=path, seed=0, device="cuda", dump_config=False)
        torch.cuda.synchronize()
        print(f"style-melgan (e) training mixed precision: steps 3 -> "
              f"{mixed.steps}")
        if mixed.steps != 5 or mixed.state.opt_g.count != 4 \
                or mixed.state.opt_d.count != 4:
            raise AssertionError("the resumed run did not take 2 steps")
        check_trainer(mixed, "style-melgan (e) training mixed", LOSS_NAMES)
        if any(p.dtype != torch.float32 or not torch.isfinite(p).all()
               for p in mixed.generator.parameters()):
            raise AssertionError("master parameters left finite float32")

        batch = mixed._to_device(next(iter(mixed.train_loader)))
        for what, t in (("f32", trainer), ("mixed", mixed)):
            step = t.train_step_factory(True, True, True)
            out[f"step_ms_{what}"] = time_ms(
                lambda: step(t.state, batch,
                             step_generator(0, t.state.steps)), reps=3)
            torch.cuda.reset_peak_memory_stats()
            step(t.state, batch, step_generator(0, t.state.steps))
            torch.cuda.synchronize()
            out[f"peak_gb_{what}"] = torch.cuda.max_memory_allocated() / 1e9
        profile_step(trainer, batch, "style-melgan f32")
        profile_step(mixed, batch, "style-melgan mixed")
        print(f"style-melgan (e) (G, adv, D) step {B} x {T}: f32 "
              f"{out['step_ms_f32']:.1f} ms "
              f"({1e3 / out['step_ms_f32']:.2f} steps/s, peak "
              f"{out['peak_gb_f32']:.2f} GB), mixed precision "
              f"{out['step_ms_mixed']:.1f} ms "
              f"({1e3 / out['step_ms_mixed']:.2f} steps/s, peak "
              f"{out['peak_gb_mixed']:.2f} GB) on {smi}")

        # (f) the loader's batch cut to 2 x 22,528, fixed z and windows:
        # every gradient on the card in f32 (k), on the CPU in f32 (p) and
        # float64 (e) (the CPU routes: references), each held to float64
        # (gate_gradients, hold_gate)
        b = {k: v[:2] for k, v in batch.items()}
        gen, dis = trainer.generator, trainer.discriminator
        g = torch.Generator().manual_seed(12)
        b["z"] = gen.draw_noise(2, b["c"].shape[1], g).to(dev)
        starts = [dis.draw_window_starts(T, g) for _ in range(3)]
        got = gate_gradients(gate_routes(gen, dis, b),
                             *style_melgan_gate_losses(trainer.criterion,
                                                       starts))
        out.update(hold_gate("style-melgan (f)", got, T))
    return out


def style_melgan_phase(dev, smi: str) -> dict:
    """Step 12: StyleMelGAN v1 served and trained, (g) with every launch
    of the five kernels counted across (a)-(e)."""
    counters = kernel_launch_counters()
    torch.cuda.synchronize()
    for wrapper in counters.values():
        wrapper.launches = 0
    out = style_melgan_serving(smi)
    out.update(style_melgan_training(dev, smi))
    torch.cuda.synchronize()
    out["launches"] = {name: wrapper.launches
                       for name, wrapper in counters.items()}
    print(f"style-melgan (g) launches of the five kernels over (a)-(f): "
          f"{out['launches']} (none is on this path)")
    if any(out["launches"].values()):
        raise AssertionError("a hand-written kernel ran on the StyleMelGAN "
                             "path")
    return out

VQ_LOSS_NAMES = ("quantization_loss", "commitment_loss",
                 "spectral_convergence_loss", "log_stft_magnitude_loss",
                 "adversarial_loss", "feature_matching_loss",
                 "generator_loss", "real_loss", "fake_loss",
                 "discriminator_loss")
# the unconditioned cut of the VCTK recipe that bin.decode serves from npy
# dumps (a conditioned VQ-VAE reads its conditions from hdf5 only)
VQVAE_V3_PLAIN = copy.deepcopy(VQVAE_V3)
VQVAE_V3_PLAIN["use_global_condition"] = False
for _key in ("num_global_embeds", "global_embed_dim"):
    del VQVAE_V3_PLAIN["generator_params"][_key]
VQVAE_V3_PLAIN["generator_params"]["decoder_conf"]["in_channels"] = 256
VQ_DOWN = 64  # the encoder's downsampling: samples a code
VQ_BENCH_BATCH, VQ_BENCH_T = 32, 131072  # 174.8 s of 24 kHz audio a call
# a near-tie: a float64 gap between a latent's two nearest distances below
# this x the scale of the terms they are summed from (||z||^2 + ||e||^2),
# the scale of f32's rounding of ||z||^2 - 2 z.e + ||e||^2
VQ_TIE = 1e-5
# and at most this share of a batch's codes may flip at near-ties: on
# seeded, separated codebooks none do
VQ_FLIP_SHARE = 0.01
# parameters that move in 13 (e)'s two G and D updates (of 21, 126 and 63;
# the same counts in every H100 run): the rest have gradients too small
# for f32 to register lr x gradient in two momentum steps
VQ_MOVED = {"G encoder": 13, "G decoder": 69, "D": 49}


def seeded_vqvae(config: dict, seed: int, dev):
    """A VQ-VAE of ``config`` with seeded weights (serving form, on
    ``dev``): the MelGAN kernels rescaled to a per-entry std of
    1 / sqrt(K Cin) (at N(0, 0.02) the latents are the encoder's biases and
    the wave sits near zero), the codebook rows latents of a seeded batch
    of sines and noise, as a dead-code restart would set them (at the
    U(+-1/K) init one or two codes win every assignment)."""
    from parallelwavegan_torch.models import VQVAE

    g = torch.Generator().manual_seed(seed)
    gen = VQVAE(**config["generator_params"], generator=g)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("kernel") and name.startswith(("encoder",
                                                            "decoder")):
                p.mul_(1.0 / (0.02 * (p.shape[0] * p.shape[1]) ** 0.5))
        gen.to(dev).eval()
        x = vq_audio(np.random.default_rng(seed), 4, 32768)
        z_e = gen.encoder(torch.from_numpy(x[..., None]).to(dev))[-1]
        flat = z_e.reshape(-1, z_e.shape[-1])
        rows = torch.randperm(flat.shape[0], generator=g)[
            :gen.codebook.embedding.shape[0]]
        gen.codebook.embedding.copy_(flat[rows.to(dev)])
    return gen


def vq_audio(rng: np.random.Generator, n: int, T: int) -> np.ndarray:
    """n seeded waves of T samples at 24 kHz: a few harmonics with a
    drifting pitch, and noise."""
    t = np.arange(T) / VQ_SR
    out = []
    for i in range(n):
        f0 = 90.0 + 25.0 * i + 20.0 * np.sin(2 * np.pi * 0.7 * t)
        phase = 2 * np.pi * np.cumsum(f0) / VQ_SR
        wave = sum(0.25 / k * np.sin(k * phase) for k in range(1, 6))
        out.append(wave + 0.02 * rng.standard_normal(T))
    return np.stack(out).astype(np.float32)


def check_codes(what: str, got, want, z_e64, embedding) -> int:
    """Codes of a route against the reference route's: equal but at
    near-ties (``layers.vq.code_gaps`` below VQ_TIE), and at most
    VQ_FLIP_SHARE of them. Prints and returns how many differ."""
    from parallelwavegan_torch.layers.vq import code_gaps

    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    differ = got != want
    n = int(differ.sum())
    if n > VQ_FLIP_SHARE * got.size:
        raise AssertionError(f"{what}: {n} of {got.size} codes differ, more "
                             f"than {VQ_FLIP_SHARE:.0%}")
    if n:
        gaps = code_gaps(z_e64, embedding).numpy()
        if (gaps[differ] >= VQ_TIE).any():
            raise AssertionError(
                f"{what}: {n} codes differ, {int((gaps[differ] >= VQ_TIE).sum())}"
                f" away from a near-tie")
    print(f"{what}: {got.size - n} of {got.size} codes equal, {n} differ at "
          f"near-ties (float64 gap < {VQ_TIE:g} (||z||^2 + max ||e||^2))")
    return n


def vqvae_serving(dev, smi: str) -> dict:
    """Step 13 (a)-(d) of the module docstring."""
    from torch.utils.flop_counter import FlopCounterMode

    from parallelwavegan_torch.bin import decode
    from parallelwavegan_torch.engine.checkpoint import (
        save_generator_checkpoint,
    )
    from parallelwavegan_torch.tools.train_step_profile import device_time
    from parallelwavegan_torch.utils.model_loader import load_model
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    out = {}
    config = VQVAE_V3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint-1steps.pkl")
        seeded = seeded_vqvae(config, 3, dev)
        save_reference_checkpoint(path, nested(seeded.state_dict()), config,
                                  steps=1)
        del seeded
        model = load_model(path, config, device=dev)
        cpu = load_model(path, config, device="cpu")  # the CPU reference
    gen, emb = model.generator, cpu.generator.codebook.embedding
    n_params = sum(p.numel() for p in gen.parameters())
    print(f"vqvae (a) conditioned_melgan_vae.v3 from a reference .pkl on "
          f"{model.device}: {n_params} parameters, codebook "
          f"{tuple(emb.shape)}, upsample factor {model.upsample_factor}")
    if model.device.type != dev.type or model.upsample_factor != 1:
        raise AssertionError("the VQ-VAE did not load as configured")

    # (b) 8 utterances of 1-6 s (one of a ragged length) with speaker ids:
    # vq_encode -> vq_decode on the card against the CPU port
    rng = np.random.default_rng(13)
    lengths = [VQ_SR * s for s in (1, 2, 3, 4, 5, 6, 2, 3)]
    lengths[2] += 1000  # not a multiple of the encoder's 64
    flips, used, walls, worst = 0, set(), [], 0.0
    for i, T in enumerate(lengths):
        audio = vq_audio(rng, 1, T)[0]
        spk = int(rng.integers(0, 128))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = model.vq_encode(audio)
        wave = model.vq_decode(codes, g=spk)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        want = cpu.vq_encode(audio)
        if codes.shape != (-(-T // VQ_DOWN),) or wave.shape != (
                len(codes) * VQ_DOWN, 1) or not np.isfinite(wave).all():
            raise AssertionError(f"vqvae (b) utterance {i}: bad shapes")
        if (codes != want).any():
            with torch.inference_mode():
                z64 = copy.deepcopy(cpu.generator).double().encoder(
                    torch.from_numpy(audio).double()[None, :, None])[-1]
            flips += check_codes(f"vqvae (b) utterance {i}", codes, want,
                                 z64, emb)
        used |= set(codes.tolist())
        ref = cpu.vq_decode(codes, g=spk)  # the card's codes on the CPU
        err = float(np.abs(wave - ref).max())
        allowed = 1e-4 * (1 + float(np.abs(ref).max()))
        if err > allowed:
            raise AssertionError(f"vqvae (b) utterance {i}: the card's wave "
                                 f"lies {err:.3e} from the CPU's")
        worst = max(worst, err / allowed)
    print(f"vqvae (b) {len(lengths)} utterances of 1-6 s in f32, card vs the "
          f"CPU port: codes equal but {flips} flips at near-ties, waves from "
          f"the same codes within {worst:.3f} of 1e-4 (1 + max); "
          f"{len(used)} distinct codes of {emb.shape[0]}; batch-1 wall "
          f"(encode + decode, host clock) first {walls[0] * 1e3:.1f} ms, "
          f"then {', '.join(f'{w * 1e3:.1f}' for w in walls[1:])} ms for "
          f"{', '.join(f'{T / VQ_SR:.2f}' for T in lengths[1:])} s")
    if len(used) < 8:
        raise AssertionError("the seeded codebook serves too few codes")
    out.update(flips=flips, codes_used=len(used), wave_ratio=worst,
               batch1_ms=[w * 1e3 for w in walls])

    # (c) decode(encode(x)) at 32 x 131,072 samples in f32, CUDA events
    x = torch.from_numpy(vq_audio(rng, VQ_BENCH_BATCH, VQ_BENCH_T)[..., None]
                         ).to(dev)
    spk = torch.arange(VQ_BENCH_BATCH, device=dev) % 128

    def forward():
        with torch.inference_mode():
            return gen.decode(gen.encode(x), g=spk)

    with FlopCounterMode(display=False) as counter:
        y = forward()
    flop = counter.get_total_flops()
    if y.shape != (VQ_BENCH_BATCH, VQ_BENCH_T, 1) or not torch.isfinite(
            y).all():
        raise AssertionError(f"vqvae (c) bad output {tuple(y.shape)}")
    del y
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(forward, reps=3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    audio_s = VQ_BENCH_BATCH * VQ_BENCH_T / VQ_SR
    bound = flop / PEAK_FLOPS[torch.float32] * 1e3
    print(f"vqvae (c) decode(encode(x)) f32 {VQ_BENCH_BATCH} x {VQ_BENCH_T} "
          f"samples ({audio_s:.1f} s of audio): {ms:.2f} ms, "
          f"{audio_s / (ms / 1e3):.1f} audio-s/s, {flop / 1e12:.3f} TFLOP "
          f"(bound {bound:.2f} ms at 67 TFLOP/s), peak memory {peak:.2f} GB "
          f"on {smi}")
    prof = device_time(forward, n=1, top=10)
    print(f"vqvae (c) profile: {prof['profiled_wall_ms']:.1f} ms wall, "
          f"device busy {prof['device_busy_ms']:.2f} ms; by kernel:")
    for row in prof["kernels"]:
        print(f"  {row['ms']:8.3f} ms x{row['calls']:4.0f}  {row['name']}")
    out.update(forward_ms=ms, audio_s_per_s=audio_s / (ms / 1e3),
               forward_tflop=flop / 1e12, forward_bound_ms=bound,
               forward_peak_gb=peak, forward_busy_ms=prof["device_busy_ms"])
    del x, model

    # (d) bin.decode on npy dumps of the unconditioned cut: its text holds
    # the codes that vq_encode gives
    with tempfile.TemporaryDirectory() as tmp:
        plain = VQVAE_V3_PLAIN
        ckpt = os.path.join(tmp, "generator.gckpt")
        save_generator_checkpoint(ckpt, seeded_vqvae(plain, 4, dev))
        conf = os.path.join(tmp, "config.json")
        with open(conf, "w") as f:
            json.dump(dict(plain, format="npy"), f)
        dump = os.path.join(tmp, "dump")
        os.makedirs(dump)
        waves = {f"utt{i}": vq_audio(rng, 1, VQ_SR * (i + 1) + 123 * i)[0]
                 for i in range(3)}
        for name, wave in waves.items():
            np.save(os.path.join(dump, f"{name}-wave.npy"), wave)
        t0 = time.perf_counter()
        decode.main(["--dumpdir", dump, "--checkpoint", ckpt, "--config",
                     conf, "--outdir", os.path.join(tmp, "out"),
                     "--device", dev.type])
        wall = time.perf_counter() - t0
        served = load_model(ckpt, plain, device=dev)
        with open(os.path.join(tmp, "out", "text")) as f:
            lines = f.read().splitlines()
        for line, (name, wave) in zip(lines, sorted(waves.items()),
                                      strict=True):
            want = served.vq_encode(wave)
            if line.split() != [name] + [str(c) for c in want] or \
                    not os.path.exists(os.path.join(tmp, "out",
                                                    f"{name}_gen.wav")):
                raise AssertionError(f"bin.decode's text for {name} is not "
                                     f"vq_encode's codes")
    print(f"vqvae (d) bin.decode on the card over npy dumps of the "
          f"unconditioned cut (decoder input 256): 3 utterances, text = "
          f"vq_encode's codes, {wall:.1f} s wall")
    return out


def write_vq_corpus(root: str, rng: np.random.Generator, n: int,
                    speakers: int, local: bool) -> None:
    """Seeded npy wav2wav dumps: n waves of 1-2 s with ``-global.npy``
    speaker ids (i % speakers) and, with ``local``, a ``-local.npy``
    condition of 2 channels at hop 64 (a log-f0 and a V/UV track)."""
    os.makedirs(root)
    for i in range(n):
        T = VQ_SR + 1500 * i
        np.save(os.path.join(root, f"utt{i}-wave.npy"), vq_audio(rng, 1, T)[0])
        np.save(os.path.join(root, f"utt{i}-global.npy"),
                np.array([i % speakers]))
        if local:
            frames = T // 64
            lf0 = 4.6 + 0.1 * np.sin(np.arange(frames) / 9.0)
            vuv = (rng.random(frames) > 0.2).astype(np.float64)
            np.save(os.path.join(root, f"utt{i}-local.npy"),
                    np.stack([lf0 * vuv, vuv], axis=1).astype(np.float32))


def vqvae_gate_losses(crit):
    """(forward, terms, d_loss) of the recipe's gate: G on the batch's
    codes (``indices``), the terms of the (G, adv) generator loss as the
    step forms it (quantisation, 0.25 x commitment, the STFT loss, 4 x the
    adversarial loss, 4 x 25 x feature matching) of (y_, z_e, z_q), and
    the discriminator loss on the prediction."""
    cfg = VQVAE_V3_TRAIN

    def stft(outs, dis, b, kinks):
        sc, mag = kinked_stft(crit["stft"], outs[0][..., 0], b["y"][..., 0],
                              kinks, "stft")
        return sc + mag

    def feature_matching(outs, dis, b, kinks):
        p_ = dis(outs[0])
        with torch.no_grad():
            p = dis(b["y"])
        return cfg["lambda_adv"] * cfg["lambda_feat_match"] * \
            kinked_feature_match(crit["feat_match"], p_, p, kinks,
                                 "feature matching")

    terms = {
        "quantization": lambda outs, dis, b, kinks: torch.mean(
            (outs[2] - outs[1].detach()) ** 2),
        "commitment": lambda outs, dis, b, kinks: cfg["lambda_commit"]
        * torch.mean((outs[1] - outs[2].detach()) ** 2),
        "stft": stft,
        "adversarial": lambda outs, dis, b, kinks: cfg["lambda_adv"] * crit[
            "gen_adv"](dis(outs[0])),
        "feature matching": feature_matching}

    def d_loss(outs, dis, b):
        real, fake = crit["dis_adv"](dis(outs[0]), dis(b["y"]))
        return real + fake

    def forward(gen, b):
        return gen(b["y"], None, b["g"], indices=b["codes"])

    return forward, terms, d_loss


def vqvae_training(dev, smi: str) -> dict:
    """Step 13 (e)-(g) of the module docstring."""
    import dataclasses

    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine import checkpoint as ckpt
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.step import (
        SHARED_STREAM,
        step_generator,
    )

    rng = np.random.default_rng(7)
    config = dict(VQVAE_V3_TRAIN, **VQVAE_V3_TRAIN_CUT, **VQVAE_V3_HOP_CUT)
    B, T = config["batch_size"], config["batch_max_steps"]
    names = VQ_LOSS_NAMES + ("vq_codes_used",)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_vq_corpus(dump, rng, n=B, speakers=4, local=False)
        initial, _, _, _, _ = init_train_state(config, seed=0, device=dev)
        n_g = sum(p.numel() for p in initial.generator.parameters())
        n_d = sum(p.numel() for p in initial.discriminator.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = run(config, dump, dump, os.path.join(tmp, "exp"), seed=0,
                      device=dev.type, dump_config=False)
        torch.cuda.synchronize()
        print(f"vqvae (e) training f32 {B} x {T} samples, G {n_g / 1e6:.2f} "
              f"M and D {n_d / 1e6:.2f} M parameters: {trainer.steps} steps "
              f"in {time.perf_counter() - t0:.1f} s wall (first calls)")
        state = trainer.state
        if trainer.steps != 3 or trainer.device.type != dev.type \
                or state.opt_g.count != 2 or state.opt_d.count != 2:
            raise AssertionError("the trainer did not take 3 steps")
        check_trainer(trainer, "vqvae (e) training f32", names,
                      VQ_LOSS_NAMES)
        print(f"  vq_codes_used {trainer.last_train_loss['train/vq_codes_used']:.1f} "
              f"of {config['generator_params']['num_embeds']}")
        # the recipe's RAdam takes plain momentum steps until its
        # rectification sets in (step 6): a parameter moves by lr x its
        # gradient, so in two steps one whose gradient lies below about
        # 1e-4 of its size (lr 1e-4 and 5e-5) stays put in f32. At least
        # as many parameters as moved in every run so far must move
        # (VQ_MOVED); the speaker table's move is printed
        gen, start = trainer.generator, initial.generator
        for what, a, b in (("G encoder", gen.encoder, start.encoder),
                           ("G decoder", gen.decoder, start.decoder),
                           ("D", trainer.discriminator,
                            initial.discriminator)):
            check_moved(what, a, b,
                        len(list(b.parameters())) - VQ_MOVED[what])
        print(f"  G speaker table moved: "
              f"{not torch.equal(gen.global_embed.embedding, start.global_embed.embedding)}")
        moved = (gen.codebook.embedding
                 - start.codebook.embedding).abs().amax(1)
        print(f"  codebook: {int((moved > 0).sum())} of {len(moved)} rows "
              f"moved, {int((moved > 0.01).sum())} by more than 0.01 "
              f"(restarts)")
        if not (moved > 0.01).any():
            raise AssertionError("the codebook did not move")
        path = os.path.join(tmp, "exp", "checkpoint-3steps.ckpt")
        ckpt.load_checkpoint(path, initial)
        for module, loaded in ((trainer.generator, initial.generator),
                               (trainer.discriminator, initial.discriminator)):
            want = dict(module.named_parameters())
            for key, p in loaded.named_parameters():
                if not torch.equal(p, want[key]):
                    raise AssertionError(f".ckpt differs on {key}")
        print(f"  {os.path.basename(path)} "
              f"({os.path.getsize(path) / 1e6:.1f} MB) loads back")
        del initial

        mixed_config = dict(config, mixed_precision=True, train_max_steps=5,
                            save_interval_steps=5, eval_interval_steps=5)
        mixed = run(mixed_config, dump, dump, os.path.join(tmp, "mixed"),
                    resume=path, seed=0, device=dev.type, dump_config=False)
        torch.cuda.synchronize()
        print(f"vqvae (e) training mixed precision: steps 3 -> {mixed.steps}")
        if mixed.steps != 5 or mixed.state.opt_g.count != 4 \
                or mixed.state.opt_d.count != 4:
            raise AssertionError("the resumed run did not take 2 steps")
        check_trainer(mixed, "vqvae (e) training mixed", names,
                      VQ_LOSS_NAMES)
        if any(p.dtype != torch.float32 or not torch.isfinite(p).all()
               for p in mixed.generator.parameters()):
            raise AssertionError("master parameters left finite float32")

        batch = mixed._to_device(next(iter(mixed.train_loader)))
        for what, t in (("f32", trainer), ("mixed", mixed)):
            step = t.train_step_factory(True, True, True)

            def one():
                step(t.state, batch, step_generator(0, t.state.steps),
                     step_generator(0, t.state.steps, SHARED_STREAM))

            out[f"step_ms_{what}"] = time_ms(one, reps=3)
            torch.cuda.reset_peak_memory_stats()
            one()
            torch.cuda.synchronize()
            out[f"peak_gb_{what}"] = torch.cuda.max_memory_allocated() / 1e9
        profile_step(trainer, batch, "vqvae f32")
        profile_step(mixed, batch, "vqvae mixed")
        print(f"vqvae (e) (G, adv, D) step {B} x {T}: f32 "
              f"{out['step_ms_f32']:.1f} ms "
              f"({1e3 / out['step_ms_f32']:.2f} steps/s, peak "
              f"{out['peak_gb_f32']:.2f} GB), mixed precision "
              f"{out['step_ms_mixed']:.1f} ms "
              f"({1e3 / out['step_ms_mixed']:.2f} steps/s, peak "
              f"{out['peak_gb_mixed']:.2f} GB) on {smi}")

        # (f) the local recipe: one f32 step (step 0 trains nothing)
        local = dict(VQVAE_LOCAL_V3_TRAIN, **VQVAE_V3_TRAIN_CUT)
        local.update(train_max_steps=2, save_interval_steps=2,
                     eval_interval_steps=2)
        ldump = os.path.join(tmp, "ldump")
        write_vq_corpus(ldump, rng, n=B, speakers=4, local=True)
        lt = run(local, ldump, ldump, os.path.join(tmp, "local"), seed=0,
                 device=dev.type, dump_config=False)
        if lt.steps != 2 or lt.state.opt_g.count != 1:
            raise AssertionError("the local run did not take its step")
        check_trainer(lt, "vqvae (f) local f32", names, VQ_LOSS_NAMES)
        lb = next(iter(lt.train_loader))
        print(f"vqvae (f) local recipe, batch y {lb['y'].shape}, l "
              f"{lb['l'].shape}, g {lb['g'].shape}: one step, losses finite")
        del lt

        # (g) the loader's batch cut to 2 x 8,192 through the trained G
        # with the seeded encoder and codebook of (a) (three steps from
        # the init leave every latent a near-tie; (a)'s codebook rows are
        # its encoder's latents of a seeded batch) and the trained D:
        # every G and D gradient on the card (k), on the CPU in f32 (p)
        # and float64 (e), on the float64 route's codes (first held to the
        # others' by the near-tie rule), held by gate_gradients and
        # hold_gate. The STFT loss on its framed product on every route:
        # the step's own method on the card ("auto" is the framed product
        # on CUDA)
        b = {k: v[:2] for k, v in batch.items()}
        crit = dict(trainer.criterion)
        crit["stft"] = dataclasses.replace(crit["stft"], method="matmul")
        seeded = seeded_vqvae(config, 5, dev)
        gen = copy.deepcopy(trainer.generator)
        gen.encoder, gen.codebook = seeded.encoder, seeded.codebook
        routes = gate_routes(gen, trainer.discriminator, b)
        codes = {}
        with torch.no_grad():
            for r, (gg, _, bb) in routes.items():
                codes[r] = gg.encode(bb["y"])
            z64 = routes["e"][0].encoder(routes["e"][2]["y"])[-1]
        emb = routes["e"][0].codebook.embedding
        for r in ("k", "p"):
            out[f"grad_flips_{r}"] = check_codes(
                f"vqvae (g) codes of route {r} vs float64", codes[r].cpu(),
                codes["e"], z64, emb)
        for r, (_, _, bb) in routes.items():
            bb["codes"] = codes["e"].to(bb["y"].device)
        out.update(hold_gate("vqvae (g)", gate_gradients(
            routes, *vqvae_gate_losses(crit)), T))
    return out


def vqvae_phase(dev, smi: str) -> dict:
    """Step 13: the VQ-VAE served and trained, (h) with every launch of the
    five kernels counted across (a)-(g)."""
    counters = kernel_launch_counters()
    torch.cuda.synchronize()
    for wrapper in counters.values():
        wrapper.launches = 0
    out = vqvae_serving(dev, smi)
    out.update(vqvae_training(dev, smi))
    torch.cuda.synchronize()
    out["launches"] = {name: wrapper.launches
                       for name, wrapper in counters.items()}
    print(f"vqvae (h) launches of the five kernels over (a)-(g): "
          f"{out['launches']} (none is on this path)")
    if any(out["launches"].values()):
        raise AssertionError("a hand-written kernel ran on the VQ-VAE path")
    return out


def seeded_uhifigan(config: dict, seed: int):
    """A UHiFiGAN generator of ``config`` with seeded weights (serving
    form, on the CPU): the N(0, 0.01) kernels rescaled to a per-entry std
    of 1 / sqrt(K Cin), the output conv's to 4 / sqrt(K Cin), so that the
    wave reaches a full-scale level (at the module's init it sits near
    1e-3)."""
    from parallelwavegan_torch.models import UHiFiGANGenerator

    gen = UHiFiGANGenerator(**config["generator_params"],
                            generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("kernel"):
                gain = 4.0 if name.startswith("output_conv") else 1.0
                p.mul_(gain / (0.01 * (p.shape[0] * p.shape[1]) ** 0.5))
    return gen.eval()


def uhifigan_inputs(rng: np.random.Generator, frames: int) -> tuple:
    """(mel (frames, 80), f0 (frames,) in Hz, excitation (frames x hop,)):
    a drifting f0 contour with unvoiced stretches, its excitation from the
    port's ``sine_excitation`` (each frame's f0 held for a hop) on a CPU
    generator seeded from ``rng``."""
    from parallelwavegan_torch.ops.sine import sine_excitation

    t = np.arange(frames)
    f0 = 180.0 + 60.0 * np.sin(t / (5.0 + 10.0 * rng.random()))
    f0 = np.where(np.sin(t / 7.0 + 6.0 * rng.random()) > -0.6, f0, 0.0)
    exc = sine_excitation(
        torch.from_numpy(np.repeat(f0, UHIFIGAN_HOP)[None, :, None]).float(),
        UHIFIGAN_SR, generator=torch.Generator().manual_seed(
            int(rng.integers(1 << 31))))[0][0, :, 0].numpy()
    mel = rng.standard_normal((frames, 80)).astype(np.float32)
    return mel, f0.astype(np.float32), exc


def uhifigan_serving(dev, smi: str) -> dict:
    """Step 14 (a)-(c) of the module docstring."""
    from scipy.io import wavfile
    from torch.utils.flop_counter import FlopCounterMode

    from parallelwavegan_torch.bin import decode
    from parallelwavegan_torch.engine.checkpoint import (
        save_generator_checkpoint,
    )
    from parallelwavegan_torch.tools.train_step_profile import device_time
    from parallelwavegan_torch.utils.model_loader import load_model
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    out = {}
    t_start = time.perf_counter()
    config = dict(UHIFIGAN_V1_TRAIN, **UHIFIGAN_V1_TRAIN_CUT)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint-1steps.pkl")
        save_reference_checkpoint(
            path, nested(seeded_uhifigan(config, 4).state_dict()), config,
            steps=1)
        m32 = load_model(path, config, device=dev)
        m16 = load_model(path, config, dtype=torch.bfloat16, device=dev)
        cpu = load_model(path, config, device="cpu")  # the CPU reference
    gen = m32.generator
    n_params = sum(p.numel() for p in gen.parameters())
    print(f"uhifigan (a) opencpop uhifigan.v1 from a reference .pkl on "
          f"{m32.device}: {n_params} parameters, upsample factor "
          f"{m32.upsample_factor}")
    if m32.device.type != dev.type or m32.upsample_factor != UHIFIGAN_HOP:
        raise AssertionError("UHiFiGAN did not load as configured")

    # (a) 8 utterances of 0.5-1.4 s with their f0 and excitation, one a
    # call at its exact length: f32 and bf16 on the card against the CPU
    # port's f32
    rng = np.random.default_rng(14)
    worst = {"f32": 0.0, "bf16": 0.0}
    walls = []
    for i, frames in enumerate((40, 57, 64, 80, 93, 100, 111, 115)):
        mel, f0, exc = uhifigan_inputs(rng, frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y32 = m32.inference(mel, f0=f0, excitation=exc)
        walls.append(time.perf_counter() - t0)
        y16 = m16.inference(mel, f0=f0, excitation=exc)
        ref = cpu.inference(mel, f0=f0, excitation=exc)
        for what, y, tol in (("f32", y32, 1e-4), ("bf16", y16, 2e-2)):
            if y.shape != (frames * UHIFIGAN_HOP, 1) or \
                    not np.isfinite(y).all():
                raise AssertionError(f"uhifigan (a) utterance {i} {what}: "
                                     f"bad output {y.shape}")
            allowed = tol * (1 + float(np.abs(ref).max()))
            err = float(np.abs(y - ref).max())
            if err > allowed:
                raise AssertionError(f"uhifigan (a) utterance {i}: the "
                                     f"card's {what} wave lies {err:.3e} "
                                     f"from the CPU's f32")
            worst[what] = max(worst[what], err / allowed)
    print(f"uhifigan (a) 8 utterances of 40-115 frames, inference(c, f0=, "
          f"excitation=) on the card vs the CPU port's f32: f32 within "
          f"{worst['f32']:.3f} of 1e-4 (1 + max), bf16 within "
          f"{worst['bf16']:.3f} of 2e-2 (1 + max); max |y| "
          f"{float(np.abs(ref).max()):.3f}; f32 batch-1 wall (host clock) "
          f"first {walls[0] * 1e3:.1f} ms, then "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls[1:])} ms")
    out.update(f32_ratio=worst["f32"], bf16_ratio=worst["bf16"],
               batch1_ms=[w * 1e3 for w in walls])
    del cpu
    print(f"uhifigan (a) {time.perf_counter() - t_start:.1f} s wall")
    t_start = time.perf_counter()

    # (b) 32 x 512 frames (204.8 s of audio) through the generator in f32
    # and bf16, CUDA events, a profile each, the bound from the FLOP count
    B, frames = UHIFIGAN_BENCH_BATCH, UHIFIGAN_BENCH_FRAMES
    T = frames * UHIFIGAN_HOP
    audio_s = B * T / UHIFIGAN_SR
    c = torch.from_numpy(rng.standard_normal((B, frames, 80)).astype(
        np.float32)).to(dev)
    exc = torch.from_numpy(np.stack([uhifigan_inputs(rng, frames)[2]
                                     for _ in range(B)])[..., None]).to(dev)
    runs = {"f32": (m32.generator, torch.float32),
            "bf16": (m16.generator, torch.bfloat16)}

    def forward(name):
        g, dtype = runs[name]
        with torch.inference_mode():
            return g(c.to(dtype), None, exc.to(dtype))

    with FlopCounterMode(display=False) as counter:
        y32 = forward("f32")
    flop = counter.get_total_flops()
    y16 = forward("bf16")
    if y32.shape != (B, T, 1) or not torch.isfinite(y32).all() \
            or not torch.isfinite(y16).all():
        raise AssertionError(f"uhifigan (b) bad output {tuple(y32.shape)}")
    err, allowed = max_err(y16, y32, torch.bfloat16)
    print(f"uhifigan (b) {B} x {frames} frames ({B * T} samples, "
          f"{audio_s:.1f} s of audio): {flop / 1e12:.3f} TFLOP a forward "
          f"({flop / (2 * B * T) / 1e6:.4f} M MAC a sample); bf16 vs f32 on "
          f"the card max_abs_err {err:.3e} (allowed {allowed:.3e})")
    if err > allowed:
        raise AssertionError("bf16 UHiFiGAN disagrees with f32")
    del y32, y16
    for name, (_, dtype) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: forward(name), reps=3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        bound = flop / PEAK_FLOPS[dtype] * 1e3
        prof = device_time(lambda: forward(name), n=1, top=10)
        out.update({f"{name}_ms": ms, f"{name}_peak_gb": peak,
                    f"{name}_bound_ms": bound,
                    f"{name}_audio_s_per_s": audio_s / (ms / 1e3),
                    f"{name}_busy_ms": prof["device_busy_ms"]})
        print(f"uhifigan (b) {name} forward {ms:.2f} ms = "
              f"{audio_s / (ms / 1e3):.1f} audio-s/s, {bound / ms:.3f} of "
              f"the bound {bound:.2f} ms ({PEAK_FLOPS[dtype] / 1e12:.0f} "
              f"TFLOP/s), peak memory {peak:.2f} GB on {smi}; profile "
              f"{prof['profiled_wall_ms']:.1f} ms wall, device busy "
              f"{prof['device_busy_ms']:.2f} ms; by kernel:")
        for row in prof["kernels"]:
            print(f"  {row['ms']:8.3f} ms x{row['calls']:4.0f}  "
                  f"{row['name']}")
    out["forward_tflop"] = flop / 1e12
    del c, exc, m16
    print(f"uhifigan (b) {time.perf_counter() - t_start:.1f} s wall")

    # (c) bin.decode on the card over -feats/-f0/-excitation.npy dumps
    # (the excitation as the reference dumps it, (frames, hop))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "generator.gckpt")
        save_generator_checkpoint(ckpt, gen)
        conf = os.path.join(tmp, "config.json")
        with open(conf, "w") as f:
            json.dump(config, f)
        dump = os.path.join(tmp, "dump")
        os.makedirs(dump)
        lengths = {f"utt{i}": 30 + 17 * i for i in range(4)}
        for name, frames in lengths.items():
            mel, f0, exc = uhifigan_inputs(rng, frames)
            np.save(os.path.join(dump, f"{name}-feats.npy"), mel)
            np.save(os.path.join(dump, f"{name}-f0.npy"), f0)
            np.save(os.path.join(dump, f"{name}-excitation.npy"),
                    exc.reshape(frames, UHIFIGAN_HOP))
        t0 = time.perf_counter()
        decode.main(["--dumpdir", dump, "--checkpoint", ckpt, "--config",
                     conf, "--outdir", os.path.join(tmp, "out"),
                     "--device", dev.type])
        wall = time.perf_counter() - t0
        for name, frames in lengths.items():
            sr, wave = wavfile.read(os.path.join(tmp, "out",
                                                 f"{name}_gen.wav"))
            if sr != UHIFIGAN_SR or wave.shape != (frames * UHIFIGAN_HOP,):
                raise AssertionError(f"bin.decode wrote {wave.shape} for "
                                     f"{name} ({frames} frames)")
    print(f"uhifigan (c) bin.decode on the card over -feats/-f0/-excitation"
          f".npy dumps: 4 utterances of {min(lengths.values())}-"
          f"{max(lengths.values())} frames, each frames x 300 samples, "
          f"{wall:.1f} s wall")
    return out


def kinked_mel(loss, x, y, kinks: dict, key: str):
    """The mel-spectrogram L1 loss ``loss`` of x against y (B, T) with its
    kinks taken from ``kinks[key]`` as ``kinked_stft`` takes its: the
    power clamp (at ``loss.eps``) before the amplitude, the mel's clamp
    (at ``loss.eps``) before the log, and the sign of the log-mel L1; its
    value held to ``loss``'s."""
    from parallelwavegan_torch.ops.spectral import (
        _mel_basis_on,
        _MatmulHighest,
        stft_magnitude,
    )

    decided = kinks.setdefault(key, [])
    eps = loss.eps
    fmin = 0.0 if loss.fmin is None else float(loss.fmin)
    fmax = loss.fs / 2.0 if loss.fmax is None else float(loss.fmax)

    def log_mel(v, i):
        amp = stft_magnitude(v, loss.fft_size, loss.hop_size,
                             loss.win_length, loss.window,
                             center=loss.center, power_clamp_min=1e-30,
                             method=loss.method)
        if len(decided) == i:
            decided.append((amp.detach() ** 2 > eps).cpu())
        amp = torch.where(decided[i].to(amp.device), amp, eps ** 0.5)
        mel = _MatmulHighest.apply(amp, _mel_basis_on(
            loss.fs, loss.fft_size, loss.num_mels, fmin, fmax, v.device,
            v.dtype))
        if len(decided) == i + 1:
            decided.append((mel.detach() > eps).cpu())
        mel = torch.where(decided[i + 1].to(mel.device), mel, eps)
        out = torch.log(mel)
        return out if loss.log_base is None else out / np.log(loss.log_base)

    d = log_mel(x, 0) - log_mel(y, 2)
    if len(decided) == 4:
        decided.append(torch.sign(d.detach()).cpu())
    total = torch.mean(decided[4].to(d) * d)
    with torch.no_grad():
        want = loss(x, y).item()
    if not abs(total.item() - want) <= 1e-5 * abs(want):
        raise AssertionError(f"{key}: the gate's mel loss {total.item()} "
                             f"is not the step's {want}")
    return total


def uhifigan_gate_losses(crit):
    """(forward, terms, d_loss) of the recipe's gate: G with dropout on,
    on the batch's keep masks (``mask_<i>``), the terms of the (G, adv)
    generator loss as the step forms it (45 x the STFT and the mel loss,
    the adversarial loss, 2 x feature matching) and the discriminator loss
    on the prediction (real pass, then fake); D in eval mode."""
    cfg = UHIFIGAN_V1_TRAIN

    def stft(outs, dis, b, kinks):
        sc, mag = kinked_stft(crit["stft"], outs[0][..., 0], b["y"][..., 0],
                              kinks, "stft")
        return cfg["lambda_aux"] * (sc + mag)

    def mel(outs, dis, b, kinks):
        return cfg["lambda_aux"] * kinked_mel(
            crit["mel"], outs[0][..., 0], b["y"][..., 0], kinks, "mel")

    def feature_matching(outs, dis, b, kinks):
        p_ = dis(outs[0])
        with torch.no_grad():
            p = dis(b["y"])
        return cfg["lambda_adv"] * cfg["lambda_feat_match"] * \
            kinked_feature_match(crit["feat_match"], p_, p, kinks,
                                 "feature matching")

    terms = {
        "stft": stft, "mel": mel,
        "adversarial": lambda outs, dis, b, kinks: cfg["lambda_adv"] * crit[
            "gen_adv"](dis(outs[0])),
        "feature matching": feature_matching}

    def d_loss(outs, dis, b):
        p = dis(b["y"])
        real, fake = crit["dis_adv"](dis(outs[0]), p)
        return real + fake

    def forward(gen, b):
        masks = [b[f"mask_{i}"] for i in range(5)]
        return (gen(b["c"], b["f0"], b["excitation"], deterministic=False,
                    masks=masks),)

    return forward, terms, d_loss


def write_uhifigan_corpus(root: str, rng: np.random.Generator, n: int
                          ) -> None:
    """Seeded npy dumps of n utterances of 40-100 frames: -wave (harmonics
    of the f0 contour, and noise), -feats, -f0 and -excitation ((frames,
    hop), as the reference dumps it)."""
    os.makedirs(root)
    for i in range(n):
        frames = 40 + (4 * i) % 61
        mel, f0, exc = uhifigan_inputs(rng, frames)
        phase = 2 * np.pi * np.cumsum(np.repeat(f0, UHIFIGAN_HOP)) / \
            UHIFIGAN_SR
        wave = sum(0.25 / k * np.sin(k * phase) for k in range(1, 5))
        wave = wave * np.repeat(f0 > 0, UHIFIGAN_HOP) + 0.01 * \
            rng.standard_normal(len(phase))
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                wave.astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"), mel)
        np.save(os.path.join(root, f"utt{i}-f0.npy"), f0)
        np.save(os.path.join(root, f"utt{i}-excitation.npy"),
                exc.reshape(frames, UHIFIGAN_HOP))


def uhifigan_training(dev, smi: str) -> dict:
    """Step 14 (d) and (e) of the module docstring."""
    import dataclasses

    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine import checkpoint as ckpt
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.step import (
        DROPOUT_STREAM,
        SHARED_STREAM,
        step_generator,
    )

    rng = np.random.default_rng(17)
    config = dict(UHIFIGAN_V1_TRAIN, **UHIFIGAN_V1_TRAIN_CUT)
    B, T = config["batch_size"], config["batch_max_steps"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_uhifigan_corpus(dump, rng, n=B)
        initial, _, _, _, _ = init_train_state(config, seed=0, device=dev)
        n_g = sum(p.numel() for p in initial.generator.parameters())
        n_d = sum(p.numel() for p in initial.discriminator.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = run(config, dump, dump, os.path.join(tmp, "exp"), seed=0,
                      device=dev.type, dump_config=False)
        torch.cuda.synchronize()
        print(f"uhifigan (d) training f32 {B} x {T} samples, G "
              f"{n_g / 1e6:.2f} M and D {n_d / 1e6:.2f} M parameters: "
              f"{trainer.steps} steps in {time.perf_counter() - t0:.1f} s "
              f"wall (first calls)")
        state = trainer.state
        if trainer.steps != 3 or trainer.device.type != dev.type \
                or state.opt_g.count != 1 or state.opt_d.count != 2:
            raise AssertionError("the trainer did not take 3 steps")
        check_trainer(trainer, "uhifigan (d) training f32",
                      UHIFIGAN_LOSS_NAMES)
        check_moved("G", trainer.generator, initial.generator, 0)
        check_moved("D", trainer.discriminator, initial.discriminator, 0)
        path = os.path.join(tmp, "exp", "checkpoint-3steps.ckpt")
        ckpt.load_checkpoint(path, initial)
        for module, loaded in ((trainer.generator, initial.generator),
                               (trainer.discriminator, initial.discriminator)):
            want = dict(module.named_parameters())
            for key, p in loaded.named_parameters():
                if not torch.equal(p, want[key]):
                    raise AssertionError(f".ckpt differs on {key}")
        print(f"  {os.path.basename(path)} "
              f"({os.path.getsize(path) / 1e6:.1f} MB) loads back")
        del initial

        t_start = time.perf_counter()
        mixed_config = dict(config, mixed_precision=True, train_max_steps=5,
                            save_interval_steps=5, eval_interval_steps=5)
        mixed = run(mixed_config, dump, dump, os.path.join(tmp, "mixed"),
                    resume=path, seed=0, device=dev.type, dump_config=False)
        torch.cuda.synchronize()
        print(f"uhifigan (d) training mixed precision: steps 3 -> "
              f"{mixed.steps}")
        if mixed.steps != 5 or mixed.state.opt_g.count != 3 \
                or mixed.state.opt_d.count != 4:
            raise AssertionError("the resumed run did not take 2 steps")
        check_trainer(mixed, "uhifigan (d) training mixed",
                      UHIFIGAN_LOSS_NAMES)
        if any(p.dtype != torch.float32 or not torch.isfinite(p).all()
               for p in mixed.generator.parameters()):
            raise AssertionError("master parameters left finite float32")

        batch = mixed._to_device(next(iter(mixed.train_loader)))
        if tuple(batch["excitation"].shape) != (B, T, 1) or \
                tuple(batch["f0"].shape) != (B, T // UHIFIGAN_HOP, 1):
            raise AssertionError("bad UHiFiGAN batch")
        for what, t in (("f32", trainer), ("mixed", mixed)):
            step = t.train_step_factory(True, True, True)

            def one():
                s = t.state.steps
                step(t.state, batch, step_generator(0, s),
                     step_generator(0, s, SHARED_STREAM),
                     step_generator(0, s, DROPOUT_STREAM, dev))

            out[f"step_ms_{what}"] = time_ms(one, reps=3)
            torch.cuda.reset_peak_memory_stats()
            one()
            torch.cuda.synchronize()
            out[f"peak_gb_{what}"] = torch.cuda.max_memory_allocated() / 1e9
        profile_step(trainer, batch, "uhifigan f32")
        profile_step(mixed, batch, "uhifigan mixed")
        print(f"uhifigan (d) (G, adv, D) step {B} x {T}: f32 "
              f"{out['step_ms_f32']:.1f} ms "
              f"({1e3 / out['step_ms_f32']:.2f} steps/s, peak "
              f"{out['peak_gb_f32']:.2f} GB), mixed precision "
              f"{out['step_ms_mixed']:.1f} ms "
              f"({1e3 / out['step_ms_mixed']:.2f} steps/s, peak "
              f"{out['peak_gb_mixed']:.2f} GB) on {smi}")

        # the dropout masks of one step's two forwards (7.3 M entries
        # each): drawn on a CPU generator and copied over, against drawn
        # on the card (what the trainer does), host clock
        gen = trainer.generator
        for where in ("cpu", "card"):
            walls = []
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g = step_generator(0, i, DROPOUT_STREAM,
                                   "cpu" if where == "cpu" else dev)
                masks = [m.to(dev) for _ in range(2)
                         for m in gen.draw_dropout_masks(B, T, g)]
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out[f"masks_ms_{where}"] = float(np.mean(walls[1:])) * 1e3
        n_mask = sum(m.numel() for m in masks)
        print(f"uhifigan (d) dropout masks of a step ({n_mask} entries, "
              f"two forwards): drawn on the host and copied "
              f"{out['masks_ms_cpu']:.2f} ms, drawn on the card "
              f"{out['masks_ms_card']:.2f} ms (host clock, mean of 3 "
              f"after one); the trainer draws them on the card")
        del masks
        print(f"uhifigan (d) resume to the masks "
              f"{time.perf_counter() - t_start:.1f} s wall")
        t_start = time.perf_counter()

        # (e) the loader's batch cut to 1 x 4,200 (UHIFIGAN_GATE_SAMPLES)
        # with one set of dropout masks handed to every route: every G and
        # D gradient on the card in f32 (k) and on the CPU in f32 (p) and
        # float64 (e), the loss's kinks decided by float64, held by
        # gate_gradients and hold_gate. The STFT and mel losses on their
        # framed products on every route (the card's own method: "auto" is
        # the framed product on CUDA)
        gate_t = UHIFIGAN_GATE_SAMPLES
        hop = config["hop_size"]
        b = {k: v[:1, :gate_t if v.shape[1] == T else gate_t // hop]
             for k, v in batch.items()}
        g = torch.Generator().manual_seed(15)
        for i, m in enumerate(gen.draw_dropout_masks(1, gate_t, g)):
            b[f"mask_{i}"] = m.to(dev)
        crit = dict(trainer.criterion)
        for name in ("stft", "mel"):
            crit[name] = dataclasses.replace(crit[name], method="matmul")
        dis = trainer.discriminator.eval()  # u stays put
        out.update(hold_gate("uhifigan (e)", gate_gradients(
            gate_routes(gen, dis, b), *uhifigan_gate_losses(crit)), gate_t,
            B=1))
        print(f"uhifigan (e) {time.perf_counter() - t_start:.1f} s wall")
    return out


def uhifigan_phase(dev, smi: str) -> dict:
    """Step 14: UHiFiGAN served and trained, (f) with every launch of the
    five kernels counted across (a)-(e)."""
    counters = kernel_launch_counters()
    torch.cuda.synchronize()
    for wrapper in counters.values():
        wrapper.launches = 0
    out = uhifigan_serving(dev, smi)
    out.update(uhifigan_training(dev, smi))
    torch.cuda.synchronize()
    out["launches"] = {name: wrapper.launches
                       for name, wrapper in counters.items()}
    print(f"uhifigan (f) launches of the five kernels over (a)-(e): "
          f"{out['launches']} (none is on this path)")
    if any(out["launches"].values()):
        raise AssertionError("a hand-written kernel ran on the UHiFiGAN "
                             "path")
    return out


def seeded_discrete(config: dict, seed: int):
    """A discrete-symbol generator of ``config`` with seeded weights
    (serving form, on the CPU). A HiFi-GAN trunk's N(0, 0.01) kernels are
    rescaled to a per-entry std of 1 / sqrt(K Cin), the output conv's to
    4 / sqrt(K Cin) (the UHiFiGAN rule: at the init the wave sits near
    1e-3); the token StyleMelGAN's trunk as ``seeded_style_melgan``; a
    duration predictor's output bias is set to 1.4, so that its
    durations sit near exp(1.4) - 1 = 3 frames (at the init they round to
    0 or 1)."""
    from parallelwavegan_torch.models import get_model_class

    gen_type = config["generator_type"]
    gen = get_model_class(gen_type)(
        **config["generator_params"],
        generator=torch.Generator().manual_seed(seed))
    style = "StyleMelGAN" in gen_type
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if not (name.startswith("trunk.") and name.endswith("kernel")):
                continue
            if style and not name.startswith(("trunk.noise_upsample",
                                              "trunk.output_conv")):
                continue
            base = 0.02 if style else 0.01
            gain = (8.0 if style else 4.0) if name.startswith(
                "trunk.output_conv") else 1.0
            p.mul_(gain / (base * (p.shape[0] * p.shape[1]) ** 0.5))
        if "Duration" in gen_type:
            gen.duration_predictor.linear.bias.fill_(1.4)
    return gen.eval()


def discrete_inputs(rng: np.random.Generator, config: dict, frames: int,
                    runs: bool = False) -> tuple:
    """(ids (frames, 1|2) int64 over the whole vocabulary, with a speaker
    column where the recipe has speakers, f0 (frames,) or None): ids in
    runs of 1 to 6 frames with ``runs``; the F0 recipe's f0 a log-Hz
    contour with unvoiced stretches at 0."""
    gp = config["generator_params"]
    if runs:
        ids = np.repeat(rng.integers(0, gp["num_embs"], frames),
                        rng.integers(1, 7, frames))[:frames]
    else:
        ids = rng.integers(0, gp["num_embs"], frames)
    c = ids[:, None]
    if gp.get("num_spk_embs", 128) > 0:
        c = np.concatenate([c, np.full_like(c, rng.integers(
            gp["num_spk_embs"]))], axis=1)
    f0 = None
    if config["generator_type"] == "DiscreteSymbolF0Generator":
        t = np.arange(frames)
        hz = 220.0 + 80.0 * np.sin(t / (4.0 + 8.0 * rng.random()))
        f0 = np.where(np.sin(t / 6.0 + 6.0 * rng.random()) > -0.6,
                      np.log(hz), 0.0).astype(np.float32)
    return c.astype(np.int64), f0


def duration_flips(card: np.ndarray, cpu: np.ndarray, offset: float) -> tuple:
    """(flipped durations, of which not near a rounding tie): the card's
    predicted durations against the CPU's, a flip excused where float64
    puts exp(d) - offset of the CPU's d within DURATION_TIE of k + 1/2."""
    ds = [np.clip(np.round(np.exp(d) - offset), 0, None) for d in (card, cpu)]
    flips = np.flatnonzero(ds[0] != ds[1])
    x = np.exp(cpu[flips].astype(np.float64)) - offset
    far = int(np.sum(np.abs(x - (np.floor(x) + 0.5)) >= DURATION_TIE))
    return len(flips), far


def teacher_forced(model, c: np.ndarray, ds: np.ndarray) -> np.ndarray:
    """A duration model's wave (float32) for ids c (T', 1|2) regulated by
    the integer durations ds (T',) (teacher forcing): the reference that a
    route's wave is held to on the durations that route's generator
    regulated by, whatever durations the reference would predict."""
    with torch.inference_mode():
        y, _ = model.generator(
            torch.from_numpy(c[None]).to(model.device),
            torch.from_numpy(np.asarray(ds, np.int64)[None]).to(model.device))
    return y[0].float().cpu().numpy()


def discrete_serving(dev, smi: str, tmp: str) -> dict:
    """Step 15 (a)-(c) of the module docstring; the .pkl files and their
    JSON configs stay in ``tmp`` for (c)."""
    from scipy.io import wavfile
    from torch.utils.flop_counter import FlopCounterMode

    from parallelwavegan_torch.bin import decode, decode_from_text
    from parallelwavegan_torch.tools.train_step_profile import device_time
    from parallelwavegan_torch.utils.model_loader import load_model
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    out = {}
    rng = np.random.default_rng(15)
    models = {}
    for name, config in DISCRETE_RECIPES.items():
        t_start = time.perf_counter()
        path = os.path.join(tmp, f"{name}.pkl")
        save_reference_checkpoint(path, nested(
            seeded_discrete(config, 15).state_dict()), config, steps=1)
        with open(os.path.join(tmp, f"{name}.json"), "w") as f:
            json.dump(config, f)
        m32 = load_model(path, config, device=dev)
        m16 = load_model(path, config, dtype=torch.bfloat16, device=dev)
        # the CPU reference; a duration model's at DURATION_CPU_REG_LEN
        # frames, as the valid frames and the trunk's reach fit there
        cpu = load_model(path, dict(config, generator_params=dict(
            config["generator_params"], max_reg_len=DURATION_CPU_REG_LEN))
            if name == "duration" else config, device="cpu")
        models[name] = m32
        hop = m32.upsample_factor
        if m32.device.type != dev.type or hop != DISCRETE_HOP:
            raise AssertionError(f"{name} did not load as configured")
        worst = {"f32": 0.0, "bf16": 0.0}
        held = {"f32": 0, "bf16": 0}
        walls, flips, far, n_ds, bf16_flips = [], 0, 0, 0, 0
        for i, frames in enumerate((40, 57, 64, 80, 93, 100, 111, 115)):
            c, f0 = discrete_inputs(rng, config, frames)
            g = lambda: torch.Generator().manual_seed(i)  # noqa: E731
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y32 = m32.inference(c, f0=f0, generator=g())
            walls.append(time.perf_counter() - t0)
            y16 = m16.inference(c, f0=f0, generator=g())
            want = {"f32": frames * hop, "bf16": frames * hop}
            if name != "duration":
                ref = cpu.inference(c, f0=f0, generator=g())
                refs = {"f32": ref, "bf16": ref}
            else:
                d32, d16, dcpu = (m.predicted_log_durations(c)
                                  for m in (m32, m16, cpu))
                n, bad = duration_flips(d32, dcpu, 1.0)
                flips, far, n_ds = flips + n, far + bad, n_ds + frames
                for what, d in (("f32", d32), ("bf16", d16)):
                    ds = np.clip(np.round(np.exp(d) - 1.0), 0, None)
                    want[what] = int(min(ds.sum(), 2048)) * hop
                # each route's wave follows the integer durations its own
                # generator rounded (bf16 rounds in bf16): the CPU's f32
                # wave teacher-forced on those, so that every wave is held
                ds_of = {"f32": m32.predicted_durations(c),
                         "bf16": m16.predicted_durations(c)}
                bf16_flips += int(np.sum(ds_of["bf16"]
                                         != cpu.predicted_durations(c)))
                if max(list(want.values()) + [int(d.sum()) * hop for d in
                       ds_of.values()]) > (DURATION_CPU_REG_LEN - 64) * hop:
                    raise AssertionError("the durations outgrow the CPU "
                                         "reference's max_reg_len")
                refs = {"f32": teacher_forced(cpu, c, ds_of["f32"])}
                refs["bf16"] = refs["f32"] if np.array_equal(
                    ds_of["f32"], ds_of["bf16"]) else teacher_forced(
                        cpu, c, ds_of["bf16"])
                ref = refs["f32"][:want["f32"]]
            for what, y, tol in (("f32", y32, 1e-4), ("bf16", y16, 2e-2)):
                if y.shape != (want[what], 1) or not np.isfinite(y).all():
                    raise AssertionError(f"{name} (a) utterance {i} {what}: "
                                         f"bad output {y.shape}, want "
                                         f"({want[what]}, 1)")
                r = refs[what][:len(y)]
                allowed = tol * (1 + float(np.abs(r).max()))
                err = float(np.abs(y - r).max())
                if err > allowed:
                    raise AssertionError(f"{name} (a) utterance {i}: the "
                                         f"card's {what} wave lies {err:.3e} "
                                         f"from the CPU's f32")
                worst[what] = max(worst[what], err / allowed)
                held[what] += 1
        if held != {"f32": 8, "bf16": 8}:
            raise AssertionError(f"{name} (a): waves held {held}, want 8 "
                                 f"of each dtype")
        line = (f"discrete (a) {name} ({config['generator_type']}, "
                f"{sum(p.numel() for p in m32.generator.parameters())} "
                f"parameters) from a reference .pkl: 8 utterances of 40-115 "
                f"tokens, ids over all "
                f"{config['generator_params']['num_embs']}, card vs the "
                f"CPU port's f32: f32 within "
                f"{worst['f32']:.3f} of 1e-4 (1 + max), bf16 within "
                f"{worst['bf16']:.3f} of 2e-2 (1 + max), every wave held "
                f"({held['f32']} f32, {held['bf16']} bf16); "
                f"max |y| {float(np.abs(ref).max()):.3f}; f32 batch-1 wall "
                f"(host clock) {', '.join(f'{w * 1e3:.1f}' for w in walls)} "
                f"ms")
        out[f"{name}_f32_ratio"] = worst["f32"]
        out[f"{name}_bf16_ratio"] = worst["bf16"]
        out[f"{name}_batch1_ms"] = [w * 1e3 for w in walls]
        if name == "duration":
            share = flips / n_ds
            line += (f"; predicted durations card vs CPU: {flips} of {n_ds} "
                     f"flipped ({far} not near a tie), bf16 {bf16_flips} "
                     f"flipped; each wave held to the CPU teacher-forced on "
                     f"its route's own durations")
            if far or share > DURATION_FLIP_SHARE:
                raise AssertionError(f"duration flips: {flips} of {n_ds}, "
                                     f"{far} not near a tie")
            out.update(duration_flips=flips, duration_tokens=n_ds,
                       duration_bf16_flips=bf16_flips,
                       duration_waves_held=held)
        print(line)
        if name == "duration":
            # the 2,048-frame trunk forward of each call, cut to sum(ds)
            audio = sum(int(min(np.clip(np.round(np.exp(
                m32.predicted_log_durations(discrete_inputs(
                    np.random.default_rng(k), config, 100)[0])) - 1.0), 0,
                None).sum(), 2048)) for k in range(4)) * hop / DISCRETE_SR
            ms = []
            for k in range(4):
                c, _ = discrete_inputs(np.random.default_rng(k), config, 100)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m32.inference(c)
                ms.append((time.perf_counter() - t0) * 1e3)
            out["duration_batch1_100_ms"] = ms
            out["duration_audio_s_per_s"] = audio / (sum(ms) / 1e3)
            print(f"discrete (b) duration batch 1 x 100 tokens, the "
                  f"{2048}-frame trunk forward cut to sum(ds) x 320: wall "
                  f"(host clock) {', '.join(f'{m:.1f}' for m in ms)} ms, "
                  f"{out['duration_audio_s_per_s']:.1f} audio-s/s on the "
                  f"cut output, on {smi}")
        del m16, cpu
        print(f"discrete (a) {name} {time.perf_counter() - t_start:.1f} s "
              f"wall")

    # (b) 32 x 512 tokens through the token generator in f32 and bf16
    t_start = time.perf_counter()
    config = DISCRETE_RECIPES["token"]
    m16 = load_model(os.path.join(tmp, "token.pkl"), config,
                     dtype=torch.bfloat16, device=dev)
    B, frames = DISCRETE_BENCH_BATCH, DISCRETE_BENCH_FRAMES
    T = frames * DISCRETE_HOP
    audio_s = B * T / DISCRETE_SR
    c = torch.from_numpy(np.stack([discrete_inputs(rng, config, frames)[0]
                                   for _ in range(B)])).to(dev)
    runs = {"f32": models["token"].generator, "bf16": m16.generator}

    def forward(name):
        with torch.inference_mode():
            return runs[name](c)

    with FlopCounterMode(display=False) as counter:
        y32 = forward("f32")
    flop = counter.get_total_flops()
    y16 = forward("bf16")
    if y32.shape != (B, T, 1) or not torch.isfinite(y32).all() \
            or not torch.isfinite(y16).all():
        raise AssertionError(f"discrete (b) bad output {tuple(y32.shape)}")
    err, allowed = max_err(y16, y32, torch.bfloat16)
    print(f"discrete (b) token {B} x {frames} tokens ({B * T} samples, "
          f"{audio_s:.1f} s of audio): {flop / 1e12:.3f} TFLOP a forward; "
          f"bf16 vs f32 on the card max_abs_err {err:.3e} (allowed "
          f"{allowed:.3e})")
    if err > allowed:
        raise AssertionError("bf16 token generator disagrees with f32")
    del y32, y16
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for name, dtype in dtypes.items():
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: forward(name), reps=3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        bound = flop / PEAK_FLOPS[dtype] * 1e3
        prof = device_time(lambda: forward(name), n=1, top=8)
        out.update({f"token_{name}_ms": ms, f"token_{name}_peak_gb": peak,
                    f"token_{name}_bound_ms": bound,
                    f"token_{name}_audio_s_per_s": audio_s / (ms / 1e3),
                    f"token_{name}_busy_ms": prof["device_busy_ms"]})
        print(f"discrete (b) token {name} forward {ms:.2f} ms = "
              f"{audio_s / (ms / 1e3):.1f} audio-s/s, {bound / ms:.3f} of "
              f"the bound {bound:.2f} ms ({PEAK_FLOPS[dtype] / 1e12:.0f} "
              f"TFLOP/s), peak memory {peak:.2f} GB on {smi}; profile "
              f"{prof['profiled_wall_ms']:.1f} ms wall, device busy "
              f"{prof['device_busy_ms']:.2f} ms; by kernel:")
        for row in prof["kernels"]:
            print(f"  {row['ms']:8.3f} ms x{row['calls']:4.0f}  "
                  f"{row['name']}")
    out["token_forward_tflop"] = flop / 1e12
    del c, m16, runs, models
    print(f"discrete (b) {time.perf_counter() - t_start:.1f} s wall")

    # (c) bin.decode over token dumps (the F0 recipe's -f0.npy read by
    # default) and bin.decode_from_text with --unique and --spk-idx
    t_start = time.perf_counter()
    for name in ("token", "f0"):
        config = DISCRETE_RECIPES[name]
        dump = os.path.join(tmp, f"dump_{name}")
        os.makedirs(dump)
        lengths = {f"utt{i}": 30 + 17 * i for i in range(3)}
        for utt, frames in lengths.items():
            c, f0 = discrete_inputs(rng, config, frames)
            np.save(os.path.join(dump, f"{utt}-feats.npy"), c)
            if f0 is not None:
                np.save(os.path.join(dump, f"{utt}-f0.npy"), f0)
        outdir = os.path.join(tmp, f"out_{name}")
        decode.main(["--dumpdir", dump, "--checkpoint",
                     os.path.join(tmp, f"{name}.pkl"), "--config",
                     os.path.join(tmp, f"{name}.json"), "--outdir", outdir,
                     "--device", dev.type])
        for utt, frames in lengths.items():
            sr, wave = wavfile.read(os.path.join(outdir, f"{utt}_gen.wav"))
            if sr != config["sampling_rate"] or \
                    wave.shape != (frames * DISCRETE_HOP,):
                raise AssertionError(f"bin.decode wrote {wave.shape} for "
                                     f"{name} {utt} ({frames} tokens)")
    text = os.path.join(tmp, "text")
    lines = {}
    with open(text, "w") as f:
        for i in range(3):
            toks = np.repeat(rng.integers(0, 100, 20), rng.integers(1, 4, 20))
            lines[f"utt{i}"] = toks
            f.write(f"utt{i} " + " ".join(map(str, toks)) + "\n")
    lengths = {}
    dur = load_model(os.path.join(tmp, "duration.pkl"),
                     DISCRETE_RECIPES["duration"], device=dev)
    for name, extra in (("token", ["--spk-idx", "5"]), ("duration", [])):
        outdir = os.path.join(tmp, f"text_{name}")
        decode_from_text.main(
            ["--text", text, "--checkpoint", os.path.join(tmp, f"{name}.pkl"),
             "--config", os.path.join(tmp, f"{name}.json"), "--outdir",
             outdir, "--unique", "--device", dev.type] + extra)
        for utt, toks in lines.items():
            n = 1 + int(np.sum(toks[1:] != toks[:-1]))
            wave = wavfile.read(os.path.join(outdir, f"{utt}_gen.wav"))[1]
            want = n * DISCRETE_HOP
            if name == "duration":
                d = dur.predicted_log_durations(
                    decode_from_text.token_lines(text, True)[int(utt[3:])][1])
                want = int(min(np.clip(np.round(np.exp(d) - 1.0), 0,
                                       None).sum(), 2048)) * DISCRETE_HOP
            if wave.shape != (want,):
                raise AssertionError(f"decode_from_text wrote {wave.shape} "
                                     f"for {name} {utt}, want ({want},)")
            lengths[f"{name} {utt}"] = len(wave)
    print(f"discrete (c) bin.decode over token dumps (token, and F0 with "
          f"-f0.npy), each frames x 320 samples; bin.decode_from_text "
          f"--unique (--spk-idx 5 for the token model) lengths "
          f"{lengths}; {time.perf_counter() - t_start:.1f} s wall")
    return out


def write_discrete_corpus(root: str, rng: np.random.Generator, n: int,
                          config: dict) -> None:
    """Seeded npy dumps of n utterances of 60-120 frames: -wave (harmonics
    of a drifting pitch, and noise), -feats of ids in runs (the speaker
    column where the recipe has one) and, for the F0 recipe, -f0."""
    os.makedirs(root)
    sr = config["sampling_rate"]
    for i in range(n):
        frames = 60 + (7 * i) % 61
        c, f0 = discrete_inputs(rng, config, frames, runs=True)
        hz = 150.0 + 3.0 * (c[:, 0] % 50)
        phase = 2 * np.pi * np.cumsum(np.repeat(hz, DISCRETE_HOP)) / sr
        wave = sum(0.25 / k * np.sin(k * phase) for k in range(1, 5)) + \
            0.01 * rng.standard_normal(len(phase))
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                wave.astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"), c)
        if f0 is not None:
            np.save(os.path.join(root, f"utt{i}-f0.npy"), f0)


def discrete_gate_losses(crit):
    """(forward, terms, d_loss) of the duration recipe's gate: G with its
    predictor's dropout on the batch's keep masks (``mask_<i>``), the
    terms of the (G, adv) generator loss as the step forms it (45 x the
    duration and the mel loss, the adversarial loss, 2 x feature
    matching), the discriminator loss on the prediction; D in eval mode."""
    cfg = DISCRETE_RECIPES["duration"]

    def mel(outs, dis, b, kinks):
        return cfg["lambda_aux"] * kinked_mel(
            crit["mel"], outs[0][..., 0], b["y"][..., 0], kinks, "mel")

    def duration(outs, dis, b, kinks):
        return cfg["lambda_aux"] * crit["duration"](outs[1], b["ds"])

    def feature_matching(outs, dis, b, kinks):
        p_ = dis(outs[0])
        with torch.no_grad():
            p = dis(b["y"])
        return cfg["lambda_adv"] * cfg["lambda_feat_match"] * \
            kinked_feature_match(crit["feat_match"], p_, p, kinks,
                                 "feature matching")

    terms = {
        "duration": duration, "mel": mel,
        "adversarial": lambda outs, dis, b, kinks: cfg["lambda_adv"] * crit[
            "gen_adv"](dis(outs[0])),
        "feature matching": feature_matching}

    def d_loss(outs, dis, b):
        p = dis(b["y"])
        real, fake = crit["dis_adv"](dis(outs[0]), p)
        return real + fake

    def forward(gen, b):
        masks = [b[f"mask_{i}"] for i in range(2)]
        return tuple(gen(b["c"], b["ds"], deterministic=False, masks=masks))

    return forward, terms, d_loss


def discrete_training(dev, smi: str) -> dict:
    """Step 15 (d) and (e) of the module docstring."""
    import dataclasses

    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine import checkpoint as ckpt
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.step import (
        DROPOUT_STREAM,
        SHARED_STREAM,
        step_generator,
    )

    rng = np.random.default_rng(18)
    config = dict(DISCRETE_RECIPES["duration"], **DURATION_TRAIN_CUT)
    B, T = config["batch_size"], config["batch_max_steps"]
    names = DISCRETE_LOSS_NAMES + ("duration_loss",)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_discrete_corpus(dump, rng, B, config)
        initial, _, _, _, _ = init_train_state(config, seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = run(config, dump, dump, os.path.join(tmp, "exp"), seed=0,
                      device=dev.type, dump_config=False)
        torch.cuda.synchronize()
        n_g = sum(p.numel() for p in trainer.generator.parameters())
        n_d = sum(p.numel() for p in trainer.discriminator.parameters())
        print(f"discrete (d) duration recipe training f32 {B} x {T} samples "
              f"(max_reg_len {trainer.generator.max_reg_len}), G "
              f"{n_g / 1e6:.2f} M and D {n_d / 1e6:.2f} M parameters: "
              f"{trainer.steps} steps in {time.perf_counter() - t0:.1f} s "
              f"wall (first calls)")
        state = trainer.state
        if trainer.steps != 3 or trainer.device.type != dev.type \
                or state.opt_g.count != 1 or state.opt_d.count != 2:
            raise AssertionError("the trainer did not take 3 steps")
        check_trainer(trainer, "discrete (d) duration f32", names)
        check_moved("G", trainer.generator, initial.generator, 0)
        check_moved("D", trainer.discriminator, initial.discriminator, 0)
        path = os.path.join(tmp, "exp", "checkpoint-3steps.ckpt")
        ckpt.load_checkpoint(path, initial)
        for module, loaded in ((trainer.generator, initial.generator),
                               (trainer.discriminator, initial.discriminator)):
            want = dict(module.named_parameters())
            for key, p in loaded.named_parameters():
                if not torch.equal(p, want[key]):
                    raise AssertionError(f".ckpt differs on {key}")
        print(f"  {os.path.basename(path)} "
              f"({os.path.getsize(path) / 1e6:.1f} MB) loads back")
        del initial
        mixed = run(dict(config, mixed_precision=True, train_max_steps=5,
                         save_interval_steps=5, eval_interval_steps=5),
                    dump, dump, os.path.join(tmp, "mixed"), resume=path,
                    seed=0, device=dev.type, dump_config=False)
        torch.cuda.synchronize()
        if mixed.steps != 5 or mixed.state.opt_g.count != 3 \
                or mixed.state.opt_d.count != 4:
            raise AssertionError("the resumed run did not take 2 steps")
        check_trainer(mixed, "discrete (d) duration mixed", names)
        batch = mixed._to_device(next(iter(mixed.train_loader)))
        if tuple(batch["ds"].shape[:1]) != (B,) or \
                not bool((batch["ds"].sum(1) == T // DISCRETE_HOP).all()):
            raise AssertionError("bad duration batch")
        for what, t in (("f32", trainer), ("mixed", mixed)):
            step = t.train_step_factory(True, True, True)

            def one():
                s = t.state.steps
                step(t.state, batch, step_generator(0, s),
                     step_generator(0, s, SHARED_STREAM),
                     step_generator(0, s, DROPOUT_STREAM, dev))

            out[f"step_ms_{what}"] = time_ms(one, reps=3)
            torch.cuda.reset_peak_memory_stats()
            one()
            torch.cuda.synchronize()
            out[f"peak_gb_{what}"] = torch.cuda.max_memory_allocated() / 1e9
        profile_step(trainer, batch, "discrete duration f32")
        profile_step(mixed, batch, "discrete duration mixed")
        gen = trainer.generator
        walls = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = step_generator(0, i, DROPOUT_STREAM, dev)
            masks = [m for _ in range(2)
                     for m in gen.batch_dropout_masks(batch, g)]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["masks_ms_card"] = float(np.mean(walls[1:])) * 1e3
        print(f"discrete (d) (G, adv, D) step {B} x {T}: f32 "
              f"{out['step_ms_f32']:.1f} ms "
              f"({1e3 / out['step_ms_f32']:.2f} steps/s, peak "
              f"{out['peak_gb_f32']:.2f} GB), mixed precision "
              f"{out['step_ms_mixed']:.1f} ms "
              f"({1e3 / out['step_ms_mixed']:.2f} steps/s, peak "
              f"{out['peak_gb_mixed']:.2f} GB) on {smi}; the predictor's "
              f"dropout masks of a step ({sum(m.numel() for m in masks)} "
              f"entries, two forwards) drawn on the card "
              f"{out['masks_ms_card']:.3f} ms (host clock)")
        del masks

        # (e) the batch cut to 1 x 10,240 with one set of masks for every
        # route, D in eval mode: every G and D gradient on the card in f32
        # (k), on the CPU in f32 (p) and float64 (e), the kinks decided by
        # float64, the duration term's cotangent included
        t_start = time.perf_counter()
        b = {k: v[:1] for k, v in batch.items()}
        n_tok = int((b["ds"] > 0).sum())
        b = {**b, "c": b["c"][:, :n_tok], "ds": b["ds"][:, :n_tok]}
        for i, m in enumerate(gen.batch_dropout_masks(
                b, torch.Generator().manual_seed(15))):
            b[f"mask_{i}"] = m.to(dev)
        crit = dict(trainer.criterion)
        crit["mel"] = dataclasses.replace(crit["mel"], method="matmul")
        dis = trainer.discriminator.eval()  # u stays put
        out.update(hold_gate("discrete (e)", gate_gradients(
            gate_routes(gen, dis, b), *discrete_gate_losses(crit)), T, B=1))
        print(f"discrete (e) {time.perf_counter() - t_start:.1f} s wall")
        del trainer, mixed, gen, dis

        # one f32 (G, adv, D) step each of the token, F0 and token
        # StyleMelGAN recipes at their full batch
        for name in ("token", "f0", "style"):
            t_start = time.perf_counter()
            cfg = dict(DISCRETE_RECIPES[name], **ONE_STEP_CUT)
            if name == "style":
                cfg["discriminator_train_start_steps"] = 1
            dump = os.path.join(tmp, f"dump_{name}")
            write_discrete_corpus(dump, rng, cfg["batch_size"], cfg)
            t = run(cfg, dump, dump, os.path.join(tmp, f"exp_{name}"),
                    seed=0, device=dev.type, dump_config=False)
            torch.cuda.synchronize()
            want = (("spectral_convergence_loss", "log_stft_magnitude_loss",
                     "generator_loss", "adversarial_loss", "real_loss",
                     "fake_loss", "discriminator_loss") if name == "style"
                    else DISCRETE_LOSS_NAMES)
            if t.steps != 3:
                raise AssertionError(f"{name} did not take 3 steps")
            check_trainer(t, f"discrete (d) {name} f32", want)
            out[f"{name}_train_s"] = time.perf_counter() - t_start
            print(f"discrete (d) {name} recipe, 3 steps (the last G and D) "
                  f"at {cfg['batch_size']} x {cfg['batch_max_steps']}: "
                  f"{out[f'{name}_train_s']:.1f} s wall")
            del t
    return out


def discrete_phase(dev, smi: str) -> dict:
    """Step 15: the discrete-symbol families served and trained, (f) with
    every launch of the five kernels counted across (a)-(e)."""
    counters = kernel_launch_counters()
    torch.cuda.synchronize()
    for wrapper in counters.values():
        wrapper.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = discrete_serving(dev, smi, tmp)
    out.update(discrete_training(dev, smi))
    torch.cuda.synchronize()
    out["launches"] = {name: wrapper.launches
                       for name, wrapper in counters.items()}
    print(f"discrete (f) launches of the five kernels over (a)-(e): "
          f"{out['launches']} (none is on this path)")
    if any(out["launches"].values()):
        raise AssertionError("a hand-written kernel ran on the discrete "
                             "path")
    return out


# ---------------------------------------------------------------------------
# 16. data-parallel training through the port's launcher


# (a) PWG v1 at the training path's 6 x 25,600 on two ranks (3 a rank), f32,
# three (G, adv, D) steps from one seeded state; (b) the same on one rank
# through NCCL; (c) StyleMelGAN v1 and (d) the VQ-VAE with restarts, one
# example a rank and two steps each (cut from their recipes' 32 and 16)
DP_STEPS = 3
DP_PWG = dict(PWG_V1, discriminator_train_start_steps=0)
DP_STYLE = dict(STYLE_MELGAN_V1_TRAIN, **STYLE_MELGAN_V1_TRAIN_CUT,
                batch_size=2)
DP_VQ = dict(VQVAE_V3_TRAIN, **VQVAE_V3_TRAIN_CUT, **VQVAE_V3_HOP_CUT,
             batch_size=2)
DP_CUT_STEPS = 2


def dp_rngs(seed: int, steps: int, dev, rank: int, world: int) -> tuple:
    """The step's three sources as ``Trainer._train_step`` seeds them."""
    from parallelwavegan_torch.engine.step import (
        DROPOUT_STREAM,
        SHARED_STREAM,
        step_generator,
    )

    return (step_generator(seed, steps, rank=rank, world=world),
            step_generator(seed, steps, SHARED_STREAM),
            step_generator(seed, steps, DROPOUT_STREAM, dev, rank=rank,
                           world=world))


def state_bits(state) -> dict:
    """Every tensor of a train state on the host, by name."""
    return {k: v.detach().cpu().clone() for k, v in state.tensors().items()}


def replicas_equal(group, state) -> bool:
    """Whether every rank holds rank 0's state bit for bit (each rank
    compares its tensors with rank 0's broadcast; the verdicts summed)."""
    tensors = [t.detach() for t in state.tensors().values()]
    own = [t.clone() for t in tensors]
    group.broadcast_tensors_(own)
    bad = torch.tensor([float(sum(not torch.equal(a, b)
                                  for a, b in zip(own, tensors)))],
                       device=tensors[0].device)
    group.sum_(bad)
    return float(bad) == 0.0


def dp_worker(job_dir: str) -> int:
    """One rank of step 16, started by ``distributed/launch.py``
    (``python3 chip_smoke.py --dp-worker DIR``): the phases that
    ``DIR/job.json`` names, each rank writing what it drew, its batches,
    its launches and its state under DIR."""
    from parallelwavegan_torch.bin.train import build_dataset, build_loader
    from parallelwavegan_torch.engine.trainer import Trainer
    from parallelwavegan_torch.ops.cuda.wavenet_stack import wavenet_stack
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        wavenet_stack_backward,
    )
    from parallelwavegan_torch.parallel import dist

    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    dev = dist.init_distributed("cuda")
    rank, world = dist.rank(), dist.world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}

    def save(name, obj):
        torch.save(obj, os.path.join(job_dir, f"{name}_rank{rank}.pt"))

    if "pwg" in job["phases"]:
        # (a) / (b): the training path's corpus through the per-rank loader
        config = DP_PWG
        loader = build_loader(config, build_dataset(config, job["dump"]), 0,
                              world, rank)
        trainer = Trainer(config, loader, None, seed=0,
                          outdir=os.path.join(job_dir, "exp"), device=dev)
        step = trainer.train_step_factory(True, True, True)
        batches, equal = [], []
        torch.cuda.synchronize()
        wavenet_stack.launches = wavenet_stack_backward.launches = 0
        for epoch in range(DP_STEPS):  # a batch an epoch or more
            loader.set_epoch(epoch)
            for batch in loader:
                if len(batches) == DP_STEPS:
                    break
                batch = trainer._to_device(batch)
                batches.append({k: v.cpu() for k, v in batch.items()})
                step(trainer.state, batch,
                     *dp_rngs(0, trainer.state.steps, dev, rank, world))
                equal.append(replicas_equal(trainer.group, trainer.state))
        torch.cuda.synchronize()
        out["pwg"] = {"fwd_launches": wavenet_stack.launches,
                      "bwd_launches": wavenet_stack_backward.launches,
                      "replicas_equal": equal,
                      "batch": list(batches[0]["y"].shape)}
        save("pwg", {"batches": batches, "state": state_bits(trainer.state)})
        del trainer
    for phase, config in (("style", DP_STYLE), ("vq", DP_VQ)):
        if phase not in job["phases"]:
            continue
        runs = []
        for _ in range(2 if phase == "style" else 1):  # (c) runs twice
            trainer = Trainer(config, None, None, seed=0,
                              outdir=os.path.join(job_dir, "exp"),
                              device=dev)
            drawn = {"z": [], "starts": []}
            T = config["batch_max_steps"]
            if phase == "style":
                gen, dis = trainer.generator, trainer.discriminator
                noise, starts = gen.draw_noise, dis.draw_window_starts

                def draw_noise(*a, _f=noise, **k):
                    z = _f(*a, **k)
                    drawn["z"].append(z.cpu())
                    return z

                def draw_starts(*a, _f=starts, **k):
                    s = _f(*a, **k)
                    drawn["starts"].append(list(s))
                    return s

                gen.draw_noise = draw_noise
                dis.draw_window_starts = draw_starts
                # the same example on every rank
                ex = np.random.default_rng(16)
                batch = {"y": torch.from_numpy(
                    0.1 * ex.standard_normal((1, T, 1)).astype(np.float32)),
                    "c": torch.from_numpy(ex.standard_normal(
                        (1, T // HOP, 80)).astype(np.float32))}
            else:  # each rank its own example and speaker
                y = vq_audio(np.random.default_rng(160 + rank), 1, T)
                batch = {"y": torch.from_numpy(y[..., None]),
                         "g": torch.tensor([3 + rank])}
            batch = {k: v.to(dev) for k, v in batch.items()}
            step = trainer.train_step_factory(True, True, True)
            metrics, equal = [], []
            for _ in range(DP_CUT_STEPS):
                _, m = step(trainer.state, batch,
                            *dp_rngs(0, trainer.state.steps, dev, rank,
                                     world))
                metrics.append({k: float(v) for k, v in m.items()})
                equal.append(replicas_equal(trainer.group, trainer.state))
            runs.append({"drawn": drawn, "metrics": metrics, "equal": equal,
                         "state": state_bits(trainer.state)})
            del trainer
        save(phase, runs)
    with open(os.path.join(job_dir, f"out_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown_distributed()
    return 0


def launch_ranks(jobs: list, dump: str, timeout: float = 600.0) -> list:
    """``distributed/launch.py`` once per job (nproc, job_dir, phases),
    all started together, each with its ranks of ``dp_worker`` on this
    card and in a session of its own, so that every process it started
    ends with it; returns each launcher's wall time."""
    import signal
    import socket

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = []
    t0 = time.perf_counter()
    try:
        for nproc, job_dir, phases in jobs:
            with open(os.path.join(job_dir, "job.json"), "w") as f:
                json.dump({"phases": phases, "dump": dump}, f)
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "parallelwavegan_torch.distributed.launch",
                 "--nproc_per_node", str(nproc), "--master_port", str(port),
                 os.path.abspath(__file__), "--dp-worker", job_dir],
                cwd=REPO, env=env, start_new_session=True))
        walls = [None] * len(procs)
        while None in walls:
            if time.perf_counter() - t0 > timeout:
                raise AssertionError("the launchers did not end in time")
            for i, proc in enumerate(procs):
                if walls[i] is None and proc.poll() is not None:
                    walls[i] = time.perf_counter() - t0
                    if proc.returncode != 0:
                        raise AssertionError(
                            f"the launcher of {jobs[i][0]} ranks ended with "
                            f"{proc.returncode}")
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return walls


def state_diff(a: dict, b: dict) -> tuple:
    """(tensors that differ, the largest difference) between two states."""
    names = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max((float((a[k].double() - b[k].double()).abs().max())
                 for k in names), default=0.0)
    return len(names), worst


def emulate_pwg(dev, world: int, batches: list) -> dict:
    """The one-process emulation of (a) (``tools/dp_emulation``: the ranks
    as threads, the gradients averaged in memory) or, at world 1, the plain
    single-process step, on the ranks' batches; rank 0's state."""
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.criterion import build_criterion
    from parallelwavegan_torch.engine.step import build_steps
    from parallelwavegan_torch.tools.dp_emulation import (
        ThreadGroup,
        run_ranks,
    )

    group = ThreadGroup(world) if world > 1 else None

    def one(rank):
        state, gen, dis, opt_g, opt_d = init_train_state(DP_PWG, 0, dev)
        factory, _ = build_steps(DP_PWG, gen, dis, build_criterion(DP_PWG),
                                 opt_g, opt_d, group=group)
        step = factory(True, True, True)
        for batch in batches[rank]:
            step(state, {k: v.to(dev) for k, v in batch.items()},
                 *dp_rngs(0, state.steps, dev, rank, world))
        torch.cuda.synchronize()
        return state_bits(state)

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        if group is None:
            return one(0)
        return run_ranks(group, one)[0]


def data_parallel_phase(dev, smi: str) -> dict:
    """Step 16 of the module docstring."""
    from parallelwavegan_torch.ops.cuda.wavenet_stack import stack_launch_plan
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        backward_launch_plan,
    )

    L = PWG_V1["generator_params"]["layers"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_corpus(dump, np.random.default_rng(1))
        jobs = [(2, os.path.join(tmp, "world2"), ["pwg", "style", "vq"]),
                (1, os.path.join(tmp, "world1"), ["pwg"])]
        for _, job, _ in jobs:
            os.makedirs(job)
        walls = dict(zip((2, 1), launch_ranks(jobs, dump)))
        print(f"data-parallel launches, started together: 2 ranks (a, c, d) "
              f"{walls[2]:.1f} s wall, 1 rank (b) {walls[1]:.1f} s wall")

        def load(world, name, rank):
            return torch.load(os.path.join(tmp, f"world{world}",
                                           f"{name}_rank{rank}.pt"),
                              weights_only=False)

        def ranks_out(world):
            outs = []
            for rank in range(world):
                with open(os.path.join(tmp, f"world{world}",
                                       f"out_rank{rank}.json")) as f:
                    outs.append(json.load(f))
            return outs

        # (a) two ranks against the one-process emulation
        t0 = time.perf_counter()
        per_rank = TRAIN_BATCH // 2
        fwd_per_forward = 3 * stack_launch_plan(
            per_rank, TRAIN_SAMPLES, 80, L // 3, torch.float32)["launches"]
        bwd_per_step = 3 * backward_launch_plan(
            per_rank, TRAIN_SAMPLES, 80, L // 3, torch.float32,
            sms)["launches"]
        outs = ranks_out(2)
        got = [load(2, "pwg", r) for r in range(2)]
        for rank, o in enumerate(outs):
            p = o["pwg"]
            print(f"data-parallel (a) rank {rank} of 2 (gloo, {dev}): PWG v1 "
                  f"f32 {p['batch'][0]} x {p['batch'][1]} a rank, "
                  f"{DP_STEPS} (G, adv, D) steps: wavenet_stack launches "
                  f"{p['fwd_launches']}, backward launches "
                  f"{p['bwd_launches']}; replicas bit-equal after each "
                  f"step: {p['replicas_equal']}")
            if p["batch"] != [per_rank, TRAIN_SAMPLES, 1] \
                    or not all(p["replicas_equal"]) \
                    or len(p["replicas_equal"]) != DP_STEPS:
                raise AssertionError("the ranks' states parted")
            if p["fwd_launches"] != 2 * DP_STEPS * fwd_per_forward or \
                    p["bwd_launches"] != DP_STEPS * bwd_per_step:
                raise AssertionError(
                    f"rank {rank}: expected {2 * DP_STEPS * fwd_per_forward}"
                    f" forward and {DP_STEPS * bwd_per_step} backward "
                    f"launches")
        out["launches"] = {
            "wavenet_stack": [o["pwg"]["fwd_launches"] for o in outs],
            "wavenet_stack_backward": [o["pwg"]["bwd_launches"]
                                       for o in outs]}
        emulated = emulate_pwg(dev, 2, [g["batches"] for g in got])
        n, worst = state_diff(emulated, got[0]["state"])
        print(f"data-parallel (a) the ranks' state against the one-process "
              f"emulation (the two half-batches' gradients averaged in "
              f"memory, cuDNN deterministic): {n} of {len(emulated)} "
              f"tensors differ (largest {worst:.3e}); "
              f"{time.perf_counter() - t0:.1f} s wall")
        if n:
            raise AssertionError("two ranks differ from the emulation")

        # (b) one rank through NCCL against the plain single-process step
        t0 = time.perf_counter()
        one = ranks_out(1)[0]["pwg"]
        got1 = load(1, "pwg", 0)
        plain = emulate_pwg(dev, 1, [got1["batches"]])
        n, worst = state_diff(plain, got1["state"])
        print(f"data-parallel (b) one rank (NCCL): PWG v1 f32 "
              f"{one['batch'][0]} x {one['batch'][1]}, {DP_STEPS} steps, "
              f"launches {one['fwd_launches']} / {one['bwd_launches']}, "
              f"against today's single-process step on its batches: {n} "
              f"tensors differ (largest {worst:.3e}); "
              f"{time.perf_counter() - t0:.1f} s wall")
        if n or one["batch"] != [TRAIN_BATCH, TRAIN_SAMPLES, 1]:
            raise AssertionError("one NCCL rank differs from one process")

        # (c) StyleMelGAN: different draws on each rank, a rerun bit-equal
        style = [load(2, "style", r) for r in range(2)]
        for rank, runs in enumerate(style):
            first, again = runs
            if not all(first["equal"] + again["equal"]):
                raise AssertionError("StyleMelGAN replicas parted")
            if state_diff(first["state"], again["state"])[0] or \
                    first["drawn"]["starts"] != again["drawn"]["starts"] or \
                    not all(torch.equal(a, b) for a, b in zip(
                        first["drawn"]["z"], again["drawn"]["z"])):
                raise AssertionError("a StyleMelGAN rerun differs")
        d0, d1 = (s[0]["drawn"] for s in style)
        z_same = sum(torch.equal(a, b) for a, b in zip(d0["z"], d1["z"]))
        starts_same = sum(a == b for a, b in zip(d0["starts"],
                                                 d1["starts"]))
        print(f"data-parallel (c) StyleMelGAN v1, 2 ranks on one example of "
              f"{DP_STYLE['batch_max_steps']} samples, {DP_CUT_STEPS} steps:"
              f" {len(d0['z'])} noise draws and {len(d0['starts'])} window "
              f"draws a rank, {z_same} and {starts_same} equal across the "
              f"ranks; replicas bit-equal; a rerun bit-equal in draws and "
              f"state; losses {style[0][0]['metrics'][-1]}")
        if z_same or starts_same or not d0["z"] or not d0["starts"]:
            raise AssertionError("the ranks drew the same noise or windows")

        # (d) the VQ-VAE's restarts keep the codebook replicated
        vq = [load(2, "vq", r) for r in range(2)]
        k = DP_VQ["generator_params"]["num_embeds"]
        if not all(runs[0]["equal"] for runs in vq) or state_diff(
                vq[0][0]["state"], vq[1][0]["state"])[0]:
            raise AssertionError("VQ-VAE replicas parted")
        used = [m["vq_codes_used"] for m in vq[0][0]["metrics"]]
        book = [v[0]["state"]["G.codebook.embedding"] for v in vq]
        print(f"data-parallel (d) VQ-VAE, 2 ranks of one example each, "
              f"{DP_CUT_STEPS} steps with restarts: codes used {used} of "
              f"{k} (the rest restarted from the ranks' mean rows), "
              f"codebook bit-equal on both ranks: "
              f"{torch.equal(book[0], book[1])}")
        if not torch.equal(book[0], book[1]) or not all(u < k for u in used):
            raise AssertionError("the VQ-VAE's codebook parted, or no code "
                                 "was dead")
    out["walls"] = walls
    return out


# step 17: the recipe front end on the card
RECIPE_YAML = os.path.join(REPO, "egs", "ljspeech", "voc1", "conf",
                           "parallel_wavegan.v1.yaml")
# step 17 (c): the recipe with its step counts and intervals cut
RECIPE_CUT = dict(train_max_steps=3, save_interval_steps=3,
                  eval_interval_steps=3, log_interval_steps=1)
RECIPE_DEV = 4        # utterances of the 24 held out for decoding and scores
RECIPE_JOBS = 4       # the stage runner's --n-jobs: jobs a set, scorers
# the card's log-mel against the CPU route's (both float64 to the f32
# cast: a few float32 roundings at |log10 mel| <= 10)
RECIPE_FEATS_TOL = 1e-5


def read_dumps(dumpdir: str) -> dict:
    """{utt: {key: array}} of a directory of hdf5 dumps."""
    from parallelwavegan_torch.utils.io import hdf5_keys, read_hdf5

    out = {}
    for path in sorted(glob.glob(os.path.join(dumpdir, "*.h5"))):
        utt = os.path.basename(path)[:-3]
        out[utt] = {k: read_hdf5(path, k) for k in hdf5_keys(path)}
    return out


def write_recipe_data(root: str, gts: list) -> dict:
    """A recipe directory's data/{train,dev,eval}/wav.scp (what a recipe's
    stage 0 writes) over the shipped ground-truth wavs: the last
    RECIPE_DEV for dev and eval, the others for train. Returns {set:
    utterance ids}."""
    utts = [os.path.basename(p)[:-4] for p in gts]
    sets = {"train": list(zip(utts, gts))[:-RECIPE_DEV],
            "dev": list(zip(utts, gts))[-RECIPE_DEV:]}
    sets["eval"] = sets["dev"]
    for name, pairs in sets.items():
        os.makedirs(os.path.join(root, "data", name))
        with open(os.path.join(root, "data", name, "wav.scp"), "w") as f:
            f.writelines(f"{u} {p}\n" for u, p in pairs)
    return {name: [u for u, _ in pairs] for name, pairs in sets.items()}


def run_recipe(root: str, **kw) -> dict:
    """bin.run_stages.run in the recipe directory ``root``."""
    from parallelwavegan_torch.bin import run_stages

    cwd = os.getcwd()
    os.chdir(root)
    try:
        return run_stages.run(**kw)
    finally:
        os.chdir(cwd)


def recipe_phase(dev) -> dict:
    """Step 17 of the module docstring."""
    from parallelwavegan_torch.bin import (
        convert_checkpoint,
        decode,
        preprocess,
        train,
    )
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.utils import yaml_lite
    from parallelwavegan_torch.utils.io import read_wav, write_hdf5
    from parallelwavegan_torch.utils.model_loader import load_model
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    counters = kernel_launch_counters()
    walls = {}
    t0 = time.perf_counter()
    # (a) every recipe file through yaml_lite
    recipes = sorted(glob.glob(os.path.join(REPO, "egs", "**", "conf",
                                            "*.yaml"), recursive=True))
    recipes.append(os.path.join(ASSET_DIR, "config.yml"))
    loaded = {path: yaml_lite.load_file(path) for path in recipes}
    if len(loaded) < 111 or not all(isinstance(c, dict) and
                                    "sampling_rate" in c
                                    for c in loaded.values()):
        raise AssertionError("a recipe file did not load as a config")
    config = loaded[RECIPE_YAML]
    hop = config["hop_size"]
    walls["a"] = time.perf_counter() - t0
    print(f"recipe (a) {len(loaded)} recipe files read by yaml_lite, "
          f"{walls['a']:.2f} s wall")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the stage runner's stage 1 over the shipped 24 ground-truth
        # wavs on the card (4 feature jobs a set), against bin.preprocess on
        # the CPU
        t0 = time.perf_counter()
        gts = sorted(glob.glob(os.path.join(ASSET_DIR, "eval_utt*-gt.wav")))
        root = os.path.join(tmp, "recipe")
        sets = write_recipe_data(root, gts)
        d = {k: os.path.join(tmp, k) for k in ("raw_cpu", "ref", "back",
                                               "ref2", "vq")}
        conf = os.path.join(root, "conf", "parallel_wavegan.v1.yaml")
        os.makedirs(os.path.dirname(conf))
        with open(conf, "w") as f:
            f.write(yaml_lite.dump(dict(config, **RECIPE_CUT)))
        drive = dict(conf=conf, n_jobs=RECIPE_JOBS, device="cuda",
                     in_process=("train", "decode"))
        t1 = time.perf_counter()
        run_recipe(root, stage=1, stop_stage=1, **drive)
        walls["stage1"] = time.perf_counter() - t1
        dump = os.path.join(root, "dump")
        scp = os.path.join(tmp, "wav.scp")
        with open(scp, "w") as f:
            f.writelines(f"{os.path.basename(p)[:-4]} {p}\n" for p in gts)
        t1 = time.perf_counter()
        preprocess.main(["--wav-scp", scp, "--dumpdir", d["raw_cpu"],
                         "--config", RECIPE_YAML, "--verbose", "0",
                         "--device", "cpu"])
        walls["preprocess_cpu"] = time.perf_counter() - t1
        card = {**read_dumps(os.path.join(dump, "train", "raw")),
                **read_dumps(os.path.join(dump, "dev", "raw"))}
        cpu = read_dumps(d["raw_cpu"])
        shards = sorted(glob.glob(os.path.join(dump, "*", "raw",
                                               "wav.*.scp")))
        if len(card) != len(gts) or sorted(card) != sorted(cpu) or \
                len(shards) != 3 * RECIPE_JOBS or \
                sorted(read_dumps(os.path.join(dump, "eval", "raw"))) != \
                sorted(sets["eval"]):
            raise AssertionError("the stage runner's stage 1 did not dump "
                                 "every utterance of every set")
        worst = 0.0
        for utt, arrays in card.items():
            if sorted(arrays) != ["feats", "wave"] or \
                    arrays["feats"].shape[1] != config["num_mels"] or \
                    len(arrays["wave"]) != len(arrays["feats"]) * hop:
                raise AssertionError(f"{utt}: a bad dump")
            if not np.array_equal(arrays["wave"], cpu[utt]["wave"]):
                raise AssertionError(f"{utt}: the card's wave is not the "
                                     "CPU route's")
            worst = max(worst, float(np.abs(arrays["feats"]
                                            - cpu[utt]["feats"]).max()))
        frames = sum(len(a["feats"]) for a in card.values())
        print(f"recipe (b) bin.run_stages stage 1 "
              f"({os.path.relpath(RECIPE_YAML, REPO)}, hdf5, --n-jobs "
              f"{RECIPE_JOBS}: {len(shards)} feature jobs) on {dev}: "
              f"{len(card)} utterances, {frames} frames, "
              f"{walls['stage1']:.2f} s wall (bin.preprocess on the CPU "
              f"{walls['preprocess_cpu']:.2f} s); feats vs the CPU route "
              f"max_abs_err {worst:.3e} (allowed {RECIPE_FEATS_TOL:.0e}), "
              f"waves bit-equal, len(wave) == len(feats) x {hop} on every "
              "file")
        if worst > RECIPE_FEATS_TOL:
            raise AssertionError("the card's log-mel disagrees with the CPU "
                                 "route")
        norm = read_dumps(os.path.join(dump, "train", "norm"))
        mean = np.mean(np.concatenate([a["feats"] for a in norm.values()]),
                       axis=0)
        if len(norm) != len(sets["train"]) or np.abs(mean).max() > 1e-4 or \
                not os.path.exists(os.path.join(dump, "train", "stats.h5")) \
                or any(not np.array_equal(a["wave"], card[u]["wave"])
                       for u, a in norm.items()):
            raise AssertionError("normalize did not standardize the feats")
        walls["b"] = time.perf_counter() - t0
        print(f"  compute_statistics + normalize: train feats mean "
              f"{np.abs(mean).max():.2e} at most; {walls['b']:.1f} s wall "
              "for (b)")

        # (c) the stage runner's stage 2: bin.train (in this process, so
        # that its launches are counted) from the cut yaml on the normalized
        # hdf5 dumps, through B1 and B2
        t0 = time.perf_counter()
        initial = init_train_state(dict(config, **RECIPE_CUT), 0, dev)[0]
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        trainer = run_recipe(root, stage=2, stop_stage=2, **drive)["train"]
        torch.cuda.synchronize()
        train_launches = {k: fn.launches for k, fn in counters.items()}
        walls["c"] = time.perf_counter() - t0
        exp = os.path.join(root, "exp", "parallel_wavegan.v1")
        saved_path = os.path.join(exp, "config.yml")
        saved = yaml_lite.load_file(saved_path)
        want = dict(config, **RECIPE_CUT, use_f0=False,
                    outdir=os.path.relpath(exp, root), resume="",
                    pretrain="", seed=0, version=train.VERSION,
                    train_dumpdir=os.path.join("dump", "train", "norm"),
                    dev_dumpdir=os.path.join("dump", "dev", "norm"))
        with open(saved_path) as f:
            if saved != want or f.read() != yaml_lite.dump(saved):
                raise AssertionError("config.yml does not load back equal")
        with open(os.path.join(exp, "train.log")) as f:
            if "Finished training" not in f.read():
                raise AssertionError("exp/<tag>/train.log lacks the run")
        losses = trainer.last_train_loss
        print(f"recipe (c) bin.run_stages stage 2 (bin.train, "
              f"{RECIPE_CUT['train_max_steps']} steps at "
              f"{config['batch_size']} x {config['batch_max_steps']}, f32) "
              f"on {len(norm)} normalized hdf5 dumps: "
              f"{walls['c']:.1f} s wall; losses "
              + ", ".join(f"{k.split('/')[-1]} {v:.4f}"
                          for k, v in sorted(losses.items()))
              + f"; launches {train_launches}; config.yml loads back equal;"
              " exp/<tag>/train.log written")
        if trainer.steps != RECIPE_CUT["train_max_steps"] or not all(
                np.isfinite(v) for v in losses.values()):
            raise AssertionError("the recipe's training did not finish")
        check_moved("G", trainer.generator, initial.generator, 4)
        if min(train_launches["wavenet_stack"],
               train_launches["wavenet_stack_backward"]) < 1:
            raise AssertionError("the recipe's training did not run B1 and "
                                 "B2")
        del trainer, initial
        torch.cuda.empty_cache()

        # (d) the stage runner's stage 3 (bin.decode of the eval dumps with
        # the newest checkpoint, in this process: counted) and stage 4 (the
        # ground truth from the raw dumps, both scores in 4 processes each)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        ckpt = os.path.join(root, run_recipe(root, stage=3, stop_stage=3,
                                             **drive)["checkpoint"])
        torch.cuda.synchronize()
        decode_launches = {k: fn.launches for k, fn in counters.items()}
        for utt in sets["eval"]:
            wave, sr = read_wav(os.path.join(exp, "wav", f"{utt}_gen.wav"))
            if sr != config["sampling_rate"] or \
                    len(wave) != len(card[utt]["wave"]) or \
                    not np.isfinite(wave).all():
                raise AssertionError(f"{utt}: a bad decoded wave")
        walls["decode"] = time.perf_counter() - t0
        print(f"recipe (d) bin.run_stages stage 3 (bin.decode of "
              f"{RECIPE_DEV} eval dumps with {os.path.basename(ckpt)}): "
              f"{walls['decode']:.1f} s wall, launches {decode_launches}")
        if decode_launches["wavenet_stack"] < 1 or \
                os.path.basename(ckpt) != "checkpoint-3steps.ckpt":
            raise AssertionError("bin.decode did not run B1 on the trained "
                                 "checkpoint")
        t0 = time.perf_counter()
        run_recipe(root, stage=4, stop_stage=4, **drive)
        walls["scores"] = time.perf_counter() - t0
        gt_wavs = sorted(os.listdir(os.path.join(exp, "gt_wav")))
        logs = []
        for name in ("evaluate_mcd", "evaluate_f0"):
            with open(os.path.join(exp, f"{name}.log")) as f:
                logs.append(f.read())
        mcd = [ln for ln in logs[0].splitlines() if ln.startswith("Mean MCD")]
        f0 = [ln for ln in logs[1].splitlines()
              if ln.startswith("Mean log-F0")]
        print(f"recipe (d) bin.run_stages stage 4 (ground truth from "
              f"dump/eval/raw: {len(gt_wavs)} wavs; bin.evaluate_mcd and "
              f"bin.evaluate_f0 in {RECIPE_JOBS} processes each) after "
              f"{RECIPE_CUT['train_max_steps'] - 1} G steps (printed, not "
              f"gated): {mcd[0] if mcd else '?'}; {f0[0] if f0 else '?'}; "
              f"{walls['scores']:.1f} s wall")
        if gt_wavs != sorted(f"{u}.wav" for u in sets["eval"]):
            raise AssertionError("stage 4 did not write the ground truth")
        if not mcd or not f0:
            raise AssertionError("a scorer printed no mean")

        # (e) .ckpt -> .pkl -> .ckpt -> .pkl through bin.convert_checkpoint,
        # the two .pkl files bit-equal
        t0 = time.perf_counter()
        first = convert_checkpoint.main([
            "--checkpoint", ckpt, "--outdir", d["ref"], "--to-reference",
            "--verbose", "0"])
        again = convert_checkpoint.main([
            "--checkpoint", first, "--outdir", d["back"], "--verbose", "0"])
        second = convert_checkpoint.main([
            "--checkpoint", again, "--outdir", d["ref2"], "--to-reference",
            "--verbose", "0"])
        a, b = (torch.load(p, weights_only=False) for p in (first, second))
        ga, gb = a["model"]["generator"], b["model"]["generator"]
        if a["steps"] != 3 or b["steps"] != 3 or sorted(ga) != sorted(gb) \
                or not all(torch.equal(ga[k], gb[k]) for k in ga):
            raise AssertionError("the .pkl did not round-trip bit-equal")
        walls["convert"] = time.perf_counter() - t0
        print(f"recipe (e) bin.convert_checkpoint .ckpt -> .pkl -> .ckpt"
              f" -> .pkl: {len(ga)} tensors bit-equal, steps 3, "
              f"{walls['convert']:.1f} s wall")
        # the conditioned VQ-VAE of step 13 from an hdf5 dump with its
        # speaker id, through bin.decode
        t0 = time.perf_counter()
        os.makedirs(d["vq"])
        pkl = os.path.join(d["vq"], "checkpoint-1steps.pkl")
        save_reference_checkpoint(pkl, nested(seeded_vqvae(
            VQVAE_V3, 3, dev).state_dict()), VQVAE_V3, steps=1)
        vq_yaml = os.path.join(d["vq"], "config.yml")
        with open(vq_yaml, "w") as f:
            f.write(yaml_lite.dump(dict(VQVAE_V3, format="hdf5")))
        wave = vq_audio(np.random.default_rng(17), 1, 2 * VQ_SR + 77)[0]
        vq_dump = os.path.join(d["vq"], "dump", "vq_utt.h5")
        write_hdf5(vq_dump, "wave", wave)
        write_hdf5(vq_dump, "global", np.array([5], dtype=np.int64))
        decode.main(["--dumpdir", os.path.dirname(vq_dump), "--checkpoint",
                     pkl, "--outdir", os.path.join(d["vq"], "out"),
                     "--verbose", "0"])
        served = load_model(pkl, VQVAE_V3, device=dev)
        codes = served.vq_encode(wave)
        want_wave = served.vq_decode(codes, g=5)[:, 0]
        got_wave, _ = read_wav(os.path.join(d["vq"], "out",
                                            "vq_utt_gen.wav"))
        with open(os.path.join(d["vq"], "out", "text")) as f:
            line = f.read().split()
        pcm = np.clip(want_wave.astype(np.float64), -1, 1) * 32767.0
        if line != ["vq_utt"] + [str(c) for c in codes] or \
                not np.array_equal((got_wave * 2**15).astype(np.int64),
                                   pcm.astype(np.int16).astype(np.int64)):
            raise AssertionError("bin.decode of the conditioned VQ-VAE "
                                 "is not vq_decode(vq_encode, g)")
        walls["vq"] = time.perf_counter() - t0
        print(f"  conditioned_melgan_vae.v3 (.pkl, yaml config) decoded "
              f"by bin.decode from an hdf5 dump with global id 5: "
              f"{len(codes)} codes and the wave equal to "
              f"vq_decode(vq_encode(x), g=5), {walls['vq']:.1f} s wall")
    return {"launches": {k: {"train": train_launches[k],
                             "decode": decode_launches[k]}
                         for k in counters},
            "walls": walls}


# step 18: the native loader, the trainer's profiler hook and the export
NATIVE_PROFILE = dict(profile_start_step=1, profile_num_steps=2)
# the kernels' names in a torch.profiler trace: B1's layer bodies and B2's
# data and weight bodies (csrc/wavenet_stack.cu, wavenet_tc_layer.cuh,
# wavenet_stack_bwd.cu)
B1_TRACE_NAME = re.compile(r"wavenet_layer_\w*kernel")
B2_TRACE_NAME = re.compile(r"bwd_\w+_kernel")
EXPORT_FRAMES = 512
EXPORT_TOL = 1e-5     # |program - module forward| <= EXPORT_TOL (1 + max)


class TimedLoader:
    """A training loader whose batches are timed: for each, when the loop
    asked for it and how long it waited for it."""

    def __init__(self, inner):
        self.inner = inner
        self.asked, self.waits = [], []

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        batches = iter(self.inner)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                return
            self.asked.append(t0)
            self.waits.append(time.perf_counter() - t0)
            yield batch


def trace_kernels(path: str) -> dict:
    """{kernel name: launches} of the device kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def native_loader_phase(dev, smi: str) -> dict:
    """Step 18 of the module docstring."""
    from parallelwavegan_torch.bin import train
    from parallelwavegan_torch.datasets.native_loader import (
        NativeMelWavLoader,
    )
    from parallelwavegan_torch.datasets.loader import DataLoader
    from parallelwavegan_torch.utils import yaml_lite
    from parallelwavegan_torch.utils.export import (
        export_generator,
        load_exported,
    )
    from parallelwavegan_torch.utils.model_loader import load_model

    counters = kernel_launch_counters()
    config = dict(yaml_lite.load_file(RECIPE_YAML), **RECIPE_CUT,
                  format="npy")
    out: dict = {"walls": {}}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) an npy copy of the recipe through the stage runner's stage 1
        t0 = time.perf_counter()
        gts = sorted(glob.glob(os.path.join(ASSET_DIR, "eval_utt*-gt.wav")))
        root = os.path.join(tmp, "recipe")
        sets = write_recipe_data(root, gts)
        conf = os.path.join(root, "conf", "parallel_wavegan.v1.npy.yaml")
        os.makedirs(os.path.dirname(conf))
        with open(conf, "w") as f:
            f.write(yaml_lite.dump(config))
        # one feature job a set: step 17 ran the sharded jobs
        run_recipe(root, conf=conf, stage=1, stop_stage=1, n_jobs=1,
                   device="cuda")
        dump = os.path.join(root, "dump")
        norm = sorted(glob.glob(os.path.join(dump, "train", "norm",
                                             "*-feats.npy")))
        if len(norm) != len(sets["train"]) or not os.path.exists(
                os.path.join(dump, "train", "stats.npy")):
            raise AssertionError("the npy recipe's stage 1 did not dump")
        out["walls"]["stage1"] = time.perf_counter() - t0
        print(f"native (a) bin.run_stages stage 1 of "
              f"{os.path.basename(conf)} (format: npy): {len(norm)} train "
              f"dumps and stats.npy, {out['walls']['stage1']:.1f} s wall")

        # (b) bin.train.run on those dumps: the native loader (auto, the
        # default) with the profiler hook on steps 1-2, then unprofiled
        # (the profiler's start takes seconds of step 1), then the PyTorch
        # loader (use_native_loader: false); every training batch is timed
        build = train.build_loader
        loaders: list = []

        def timed_build(config, dataset, seed, *args):
            # run() builds the training loader first, then the dev loader
            loaders.append(build(config, dataset, seed, *args))
            return TimedLoader(loaders[-1]) if len(loaders) % 2 \
                else loaders[-1]

        runs = {}
        train.build_loader = timed_build
        try:
            for name, extra in (
                    ("native_profiled",
                     dict(profile_dir=os.path.join(tmp, "prof"),
                          **NATIVE_PROFILE)),
                    ("native", {}),
                    ("pytorch", dict(use_native_loader=False))):
                torch.cuda.synchronize()
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                trainer = train.run(
                    dict(config, **extra), os.path.join(dump, "train", "norm"),
                    os.path.join(dump, "dev", "norm"),
                    os.path.join(tmp, f"exp_{name}"), device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                timed = trainer.train_loader
                runs[name] = {
                    "wall_s": wall,
                    "launches": {k: fn.launches for k, fn in counters.items()},
                    "loader": type(timed.inner).__name__,
                    "batch_wait_ms": [w * 1e3 for w in timed.waits],
                    "step_wall_ms": [(b - a) * 1e3 for a, b in
                                     zip(timed.asked, timed.asked[1:])],
                    "losses": trainer.last_train_loss,
                    "trace": trainer.profile_trace,
                }
                del trainer
                torch.cuda.empty_cache()
        finally:
            train.build_loader = build
        native, plain = runs["native"], runs["pytorch"]
        profiled = runs["native_profiled"]
        for name, run in runs.items():
            print(f"native (b) bin.train.run ({name} loader: {run['loader']}"
                  f", {RECIPE_CUT['train_max_steps']} steps at "
                  f"{config['batch_size']} x {config['batch_max_steps']}, "
                  f"f32) on {smi}: {run['wall_s']:.2f} s wall; each batch's "
                  "wait for the loader "
                  + ", ".join(f"{w:.2f}" for w in run["batch_wait_ms"])
                  + " ms; step walls (batch to batch) "
                  + ", ".join(f"{w:.1f}" for w in run["step_wall_ms"])
                  + f" ms; launches {run['launches']}")
        if {native["loader"], profiled["loader"]} != {
                NativeMelWavLoader.__name__} or \
                plain["loader"] != DataLoader.__name__:
            raise AssertionError("the loaders were not the ones asked for")
        for run in runs.values():
            if len(run["batch_wait_ms"]) != RECIPE_CUT["train_max_steps"] \
                    or not all(np.isfinite(v) for v in run["losses"].values()):
                raise AssertionError("a loader's training did not finish")
        if min(native["launches"]["wavenet_stack"],
               native["launches"]["wavenet_stack_backward"]) < 1:
            raise AssertionError("the native loader's run did not launch "
                                 "B1 and B2")
        want = os.path.join(tmp, "prof", "rank0-steps1-2.pt.trace.json")
        if profiled["trace"] != want or not os.path.exists(want) or \
                native["trace"] is not None:
            raise AssertionError(f"no trace at {want}")
        kernels = trace_kernels(want)
        b1 = {k: n for k, n in kernels.items() if B1_TRACE_NAME.search(k)}
        b2 = {k: n for k, n in kernels.items() if B2_TRACE_NAME.search(k)}
        print(f"native (c) profile_dir with steps [1, 3): "
              f"{os.path.basename(want)} holds {sum(kernels.values())} "
              f"kernel launches of {len(kernels)} kernels; B1 "
              + ", ".join(f"{k[:48]} x {n}" for k, n in b1.items())
              + "; B2 " + ", ".join(f"{k[:48]} x {n}" for k, n in b2.items()))
        if not b1 or not b2:
            raise AssertionError("the profiler trace does not name B1's and "
                                 "B2's kernels")
        out["runs"] = runs

    # (d) the shipped HiFi-GAN v1 exported at 1 x 512 frames on the card
    t0 = time.perf_counter()
    model = load_model(os.path.join(ASSET_DIR, "generator.gckpt"), HIFIGAN_V1,
                       dtype=torch.float32, device=dev)
    mel = np.concatenate(asset_mels()[0])[:EXPORT_FRAMES]
    blob = export_generator(model, batch_size=1, num_frames=EXPORT_FRAMES)
    program = load_exported(blob)
    out["walls"]["export"] = time.perf_counter() - t0
    x = torch.from_numpy(mel[None]).to(dev)
    with torch.no_grad():
        want = model.generator(x)
        got = program(x)
        program_ms = time_ms(lambda: program(x), reps=5)
        module_ms = time_ms(lambda: model.generator(x), reps=5)
    err = float((got - want).abs().max())
    allowed = EXPORT_TOL * (1 + float(want.abs().max()))
    print(f"native (d) export_generator(HiFi-GAN v1 asset, 1 x "
          f"{EXPORT_FRAMES} frames) on {dev}: {len(blob)} bytes, "
          f"{out['walls']['export']:.1f} s wall to export and load; the "
          f"program against the module forward max_abs_err {err:.3e} "
          f"(allowed {allowed:.3e}); {program_ms:.2f} ms a call, the module "
          f"forward {module_ms:.2f} ms ({smi})")
    if tuple(got.shape) != (1, EXPORT_FRAMES * 256, 1) or err > allowed:
        raise AssertionError("the exported program disagrees with the "
                             "module forward")
    out["export"] = {"err": err, "allowed": allowed, "ms": program_ms,
                     "module_ms": module_ms}
    return out


def op_census_phase(dev, smi: str, pool) -> None:
    """Step 19: the op census (tools/op_census.py) of one f32 (G, adv, D)
    step of each of CENSUS_RECIPES at its width and batch, the CPU routes
    on ``pool``. Prints the table by op kind and the total; raises on a
    wrong key."""
    from parallelwavegan_torch.tools.op_census import report, run_census

    report(run_census(CENSUS_RECIPES, dev, pool), smi)


# worker processes of the pool that step 2h's host scoring and step 19's
# CPU routes run on
POOL_WORKERS = 6


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from parallelwavegan_torch.ops.cuda.build import build_libraries

    smi = card_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    built = build_libraries(["wavenet_stack", "wavenet_stack_bwd",
                             "mrf_stage", "matmul_bench", "wavenet_variant"])
    print(f"build: {time.perf_counter() - t0:.1f} s wall")
    for name, info in built.items():
        print(f"  {name}: {info['seconds']:.1f} s -> {info['path']}")
        for line in str(info["log"]).splitlines():
            if "registers" in line or "smem" in line or (
                    "spill" in line and "0 bytes spill stores, 0 bytes "
                    "spill loads" not in line):
                print(f"    {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the host scoring of step 2h runs in worker processes beside the
    # device work that follows it; they are joined before the training
    # path, whose step time depends on the host
    pool = ProcessPoolExecutor(
        max_workers=POOL_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    try:
        return run_phases(dev, smi, pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(dev, smi: str, pool) -> int:
    from parallelwavegan_torch.engine.checkpoint import (
        save_generator_checkpoint,
    )
    from parallelwavegan_torch.models import ParallelWaveGANGenerator
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        stack_launch_plan,
        wavenet_stack,
        wavenet_stack_reference,
    )
    from parallelwavegan_torch.utils.model_loader import load_model

    # 2. kernel against plain on the card
    worst_new = check_mrf_and_matmul_kernels(dev)
    worst_new["wavenet_variant"] = check_variant_kernel(dev)
    # 2h. HiFi-GAN v1 serving on the shipped checkpoint
    hifi = hifigan_phase(dev, smi, pool)
    gen = torch.Generator().manual_seed(0)
    cases = [  # (dtype, B, T, dilations)
        (torch.float32, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.bfloat16, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.float32, 3, 300, tuple(2 ** (i % 10) for i in range(30))),
        (torch.bfloat16, 2, 4133, tuple(2 ** (i % 10) for i in range(30))),
        (torch.float32, 1, 77, (3,)),
        (torch.bfloat16, 1, 130, (512, 1)),
        (torch.bfloat16, 1, 40, (1,)),
        (torch.bfloat16, 2, 50, (64, 2)),
        (torch.bfloat16, 1, 4133, (1, 32, 63, 64, 65, 512)),
    ]
    for dtype, B, T, dils in cases:
        x, c, w = stack_inputs(gen, B, T, len(dils), dtype, dev)
        xo, sk = wavenet_stack(x, c, w, dils)
        torch.cuda.synchronize()
        xo_p, sk_p = wavenet_stack_reference(x, c, w, dils)
        for what, a, b in (("x", xo, xo_p), ("skip", sk, sk_p)):
            err, allowed = max_err(a, b, dtype)
            print(f"stack {str(dtype)[6:]} B={B} T={T} L={len(dils)} "
                  f"max_d={max(dils)} {what}: max_abs_err {err:.3e} "
                  f"(allowed {allowed:.3e})")
            if err > allowed:
                raise AssertionError(f"wavenet_stack disagrees on {what}")
    train_cases = [
        (torch.float32, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.bfloat16, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.float32, 2, 333, tuple(2 ** i for i in range(10))),
        (torch.bfloat16, 3, 2117, tuple(2 ** i for i in range(10))),
        (torch.float32, 1, 77, (3,)),
        (torch.bfloat16, 1, 130, (512, 1)),
    ]
    worst = check_training_kernels(gen, dev, train_cases)

    # 3. main path at full PWG v1 width, through a .gckpt the port writes
    model_gen = ParallelWaveGANGenerator(
        **PWG_V1["generator_params"], generator=torch.Generator().manual_seed(0)
    )
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "generator.gckpt")
        save_generator_checkpoint(ckpt, model_gen)
        model32 = load_model(ckpt, PWG_V1, dtype=torch.float32, device="cuda")
        model16 = load_model(ckpt, PWG_V1, dtype=torch.bfloat16,
                             device="cuda")
    if model32.stack_params is None or model16.stack_params is None:
        raise AssertionError("InferenceModel does not route to the kernel")

    # (a) batch 1, f32: fused serving path vs the unfused plain generator
    mel = rng.standard_normal((60, 80)).astype(np.float32)
    noise = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
    wave = model32.synthesize_batch([mel], generator=noise(), bucket_size=1)[0]
    _, (c1, z1), _ = model32.prepare_batch([mel], generator=noise(),
                                           bucket_size=1)
    with torch.inference_mode():
        y_plain = model32.generator(z1, c1)[0].float().cpu()
    err, allowed = max_err(torch.from_numpy(wave), y_plain, torch.float32)
    print(f"main path (a) f32 batch 1 x 60 frames: max_abs_err {err:.3e} vs "
          f"plain generator (allowed {allowed:.3e})")
    if wave.shape != (60 * HOP, 1) or err > allowed:
        raise AssertionError("fused f32 forward disagrees with the plain one")

    # (b) bench shape, bf16: the counted run of the main path
    mels = [rng.standard_normal((BENCH_FRAMES, 80)).astype(np.float32)
            for _ in range(BENCH_BATCH)]
    torch.cuda.synchronize()
    wavenet_stack.launches = 0
    t0 = time.perf_counter()
    waves = model16.synthesize_batch(mels)
    wall = time.perf_counter() - t0
    launches = wavenet_stack.launches
    print(f"main path (b) bf16 {BENCH_BATCH} x {BENCH_FRAMES} frames: "
          f"synthesize_batch {wall * 1e3:.1f} ms wall (first call), "
          f"wavenet_stack launches {launches}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = stack_launch_plan(BENCH_BATCH, BENCH_FRAMES * HOP,
                             PWG_V1["num_mels"], model16.generator.layers,
                             torch.bfloat16, sms)
    print(f"  launch plan: {plan}")
    if launches != plan["launches"]:
        raise AssertionError(f"expected {plan['launches']} launches")
    for w in waves:
        if w.shape != (BENCH_FRAMES * HOP, 1) or not np.isfinite(w).all():
            raise AssertionError("bad bf16 output")

    # (c) bench shape, f32 (decode's default dtype): the counted run of the
    # f32 body
    torch.cuda.synchronize()
    wavenet_stack.launches = 0
    t0 = time.perf_counter()
    waves = model32.synthesize_batch(mels)
    wall = time.perf_counter() - t0
    launches32 = wavenet_stack.launches
    plan32 = stack_launch_plan(BENCH_BATCH, BENCH_FRAMES * HOP,
                               PWG_V1["num_mels"], model32.generator.layers,
                               torch.float32, sms)
    print(f"main path (c) f32 {BENCH_BATCH} x {BENCH_FRAMES} frames: "
          f"synthesize_batch {wall * 1e3:.1f} ms wall (first call), "
          f"wavenet_stack launches {launches32}; launch plan: {plan32}")
    if launches32 != plan32["launches"] \
            or plan32["body"] != "tensor_cores_tf32x3":
        raise AssertionError(f"expected {plan32['launches']} launches on "
                             f"the split-TF32 body")
    for w in waves:
        if w.shape != (BENCH_FRAMES * HOP, 1) or not np.isfinite(w).all():
            raise AssertionError("bad f32 output")
    del waves

    # the host scores must be in before the timed phases: the forward's
    # launch path, the matmul bench's short products and the training path
    # all run on the host beside the device
    check_quality(hifi)

    # 4. timing at the main path's shapes, in both serving dtypes
    serving = {dtype: serving_timing(model, mels, dtype, sms, smi)
               for dtype, model in ((torch.bfloat16, model16),
                                    (torch.float32, model32))}
    s16, s32 = serving[torch.bfloat16], serving[torch.float32]

    mm = matmul_phase(dev, smi)

    # 5, 6. the training path
    t0 = time.perf_counter()
    train = training_phase(dev, smi)
    print(f"steps 5-6: {time.perf_counter() - t0:.1f} s wall")
    # 7. the gate and int8 experiment; 8. HiFi-GAN v1 training
    variant = variant_phase(dev, smi)
    hifigan_training_phase(dev, smi)
    # 9. the MelGAN family from reference .pkl files, the asset as a .pkl
    # through bin.decode, and chunked synthesis
    t0 = time.perf_counter()
    melgan = melgan_phase(smi)
    with tempfile.TemporaryDirectory() as tmp:
        pkl_decode_phase(tmp)
    chunked = chunked_phase(dev, smi, melgan.pop("model"))
    print(f"step 9: {time.perf_counter() - t0:.1f} s wall")
    # 10. training of multi-band MelGAN v2 and of Parallel WaveGAN v3
    t0 = time.perf_counter()
    melgan_training_phase(dev, smi)
    pwg_v3 = pwg_v3_training_phase(dev, smi)
    print(f"step 10: {time.perf_counter() - t0:.1f} s wall")
    # 12. StyleMelGAN v1 serving and training
    t0 = time.perf_counter()
    style = style_melgan_phase(dev, smi)
    print(f"step 12: {time.perf_counter() - t0:.1f} s wall")
    # 13. the VQ-VAE served and trained
    t0 = time.perf_counter()
    vq = vqvae_phase(dev, smi)
    print(f"step 13: {time.perf_counter() - t0:.1f} s wall")
    # 14. UHiFiGAN served and trained
    t0 = time.perf_counter()
    uh = uhifigan_phase(dev, smi)
    print(f"step 14: {time.perf_counter() - t0:.1f} s wall")
    # 15. the discrete-symbol families served and trained
    t0 = time.perf_counter()
    disc = discrete_phase(dev, smi)
    print(f"step 15: {time.perf_counter() - t0:.1f} s wall")
    # 16. data-parallel training through the launcher
    t0 = time.perf_counter()
    dp = data_parallel_phase(dev, smi)
    print(f"step 16: {time.perf_counter() - t0:.1f} s wall")
    # 17. the recipe front end: yaml and hdf5 on the card, preprocess to
    # decode
    t0 = time.perf_counter()
    recipe = recipe_phase(dev)
    print(f"step 17: {time.perf_counter() - t0:.1f} s wall")
    rl = recipe["launches"]
    # 18. the native loader against the PyTorch loader, the profiler hook,
    # the serving export
    t0 = time.perf_counter()
    native = native_loader_phase(dev, smi)
    print(f"step 18: {time.perf_counter() - t0:.1f} s wall")
    nl = native["runs"]["native"]["launches"]
    # 19. every card op of the training steps held to float64
    t0 = time.perf_counter()
    op_census_phase(dev, smi, pool)
    print(f"step 19: {time.perf_counter() - t0:.1f} s wall")
    if min(launches, launches32, train["fwd_launches"], train["bwd_launches"],
           hifi["launches"], mm["launches"], variant["launches"],
           chunked["pwg_launches"], chunked["mrf_launches"],
           *dp["launches"]["wavenet_stack"],
           *dp["launches"]["wavenet_stack_backward"],
           rl["wavenet_stack"]["train"], rl["wavenet_stack"]["decode"],
           rl["wavenet_stack_backward"]["train"], nl["wavenet_stack"],
           nl["wavenet_stack_backward"]) < 1:
        raise AssertionError("a kernel of a main path was never launched")

    # no single PyTorch call computes the stack or its backward: library_ms
    # is null for both. ms, plain_ms and bound_ms are at the shape of the
    # path that "launches" counts: bf16 serving for the forward (f32
    # serving, counted in its own run, and the training path beside it),
    # training for the backward.
    # mrf_stage: the four stages of one bf16 forward at batch 32 x 512
    # frames on bf16 packs (the int8 packs' times beside them); its library
    # time is the exact forward's own cuDNN conv chain of the same stages
    # (mrf_chain_stage). max_rel_err: max |a - b| / (1 + max |plain|), the
    # quantity the tolerances hold, over the checks of max_abs_err. matmul_bench: the
    # five MRF contraction shapes in int8 (bf16 beside them); its library
    # time is torch._int_mm (torch.matmul). wavenet_variant: one call of 10
    # layers at batch 32 x 512 frames as the tool times it, ms for the bf16
    # tanh variant, the plain bf16 tanh version; under "variants" each
    # variant's body, plan, ms, bound, per-layer byte floor and error, and
    # the serving kernel on the same layers beside them; no single PyTorch
    # call computes it.
    kernels = [{
        "name": "wavenet_stack",
        "route": "cuda",
        "source": "parallelwavegan_torch/csrc/wavenet_stack.cu",
        "replaces": "parallelwavegan_tpu/ops/pallas/wavenet_stack.py:113",
        "launches": launches,
        "max_abs_err": max(s16["err"], s32["err"], worst["wavenet_stack"],
                           train["fwd_err"]),
        "max_rel_err": REL_ERR.get("wavenet_stack", 0.0),
        "ms": s16["ms"],
        "plain_ms": s16["plain_ms"],
        "bound_ms": s16["bound_ms"],
        "bound_by": s16["bound_by"],
        "library_ms": None,
        "tflop_per_s": s16["tflop_per_s"],
        "plan": s16["plan"],
        "f32_launches": launches32,
        "f32_ms": s32["ms"],
        "f32_plain_ms": s32["plain_ms"],
        "f32_bound_ms": s32["bound_ms"],
        "f32_bound_by": s32["bound_by"],
        "f32_bytes_floor_ms": s32["bytes_floor_ms"],
        "f32_tflop_per_s": s32["tflop_per_s"],
        "f32_plan": s32["plan"],
        "forward_ms": {"bf16": s16["forward_ms"], "f32": s32["forward_ms"]},
        "train_launches": train["fwd_launches"],
        "train_ms": train["fwd_train_ms"],
        "train_plain_ms": train["fwd_plain_ms"],
        "train_bound_ms": train["fwd_bound_ms"],
        "train_plan": train["fwd_plan"],
        "chunked_launches": chunked["pwg_launches"],
        "pwg_v3_launches": pwg_v3["fwd_launches"],
    }, {
        "name": "wavenet_stack_backward",
        "route": "cuda",
        "source": "parallelwavegan_torch/csrc/wavenet_stack_bwd.cu",
        "replaces":
            "parallelwavegan_tpu/ops/pallas/wavenet_stack_train.py:62",
        "launches": train["bwd_launches"],
        "max_abs_err": max(train["bwd_err"],
                           worst["wavenet_stack_backward"]),
        "max_rel_err": REL_ERR.get("wavenet_stack_backward", 0.0),
        "ms": train["bwd_ms"],
        "plain_ms": train["bwd_plain_ms"],
        "bound_ms": train["bwd_bound_ms"],
        "bound_by": train["bwd_bound_by"],
        "library_ms": None,
        "plan": train["bwd_plan"],
        "bound_peak": {"tensor_cores_tf32x3": "TF32 tensor cores / 3",
                       "tensor_cores_bf16": "bf16 tensor cores"},
        "bytes_floor_ms": train["bwd_bytes_floor_ms"],
        "bf16_ms": train["bwd_bf16_ms"],
        "bf16_plan": train["bwd_bf16_plan"],
        "bf16_bound_ms": train["bwd_bf16_bound_ms"],
        "bf16_bytes_floor_ms": train["bwd_bf16_bytes_floor_ms"],
        "bf16_tflop_per_s": train["bwd_bf16_tflop_per_s"],
        "bf16_max_rel_err": REL_ERR.get("wavenet_stack_backward_bf16", 0.0),
        "f32_rel_err_vs_float64": train["bwd_f32_vs_float64"],
        "generator_grad_gate": train["grad_gate"],
        "pwg_v3_launches": pwg_v3["bwd_launches"],
    }, {
        "name": "mrf_stage",
        "route": "cuda",
        "source": "parallelwavegan_torch/csrc/mrf_stage.cu",
        "replaces": "parallelwavegan_tpu/ops/pallas/mrf_stage.py:75",
        "launches": hifi["launches"],
        "max_abs_err": max(hifi["err"], worst_new["mrf_stage"]),
        "max_rel_err": REL_ERR.get("mrf_stage", 0.0),
        "ms": hifi["ms"],
        "plain_ms": hifi["plain_ms"],
        "bound_ms": hifi["bound_ms"],
        "bound_by": hifi["bound_by"],
        "library_ms": hifi["library_ms"],
        "int8_ms": hifi["int8_ms"],
        "int8_bound_ms": hifi["int8_bound_ms"],
        "stages": hifi["stages"],
        "forward_ms": {k: hifi[k] for k in (
            "exact_ms", "chain_auto_ms", "chain_all_ms", "kernel_bf16_ms",
            "kernel_int8_ms")},
        "chunked_launches": chunked["mrf_launches"],
    }, {
        "name": "matmul_bench",
        "route": "cuda",
        "source": "parallelwavegan_torch/csrc/matmul_bench.cu",
        "replaces": "tools/int8_stage_roofline.py:150",
        "launches": mm["launches"],
        "max_abs_err": worst_new["matmul_bench"],
        "max_rel_err": REL_ERR.get("matmul_bench", 0.0),
        "ms": mm["int8_ms"],
        "plain_ms": mm["int8_plain_ms"],
        "bound_ms": mm["int8_bound_ms"],
        "bound_by": mm["bound_by"],
        "library_ms": mm["int8_library_ms"],
        "graph_ms": mm["int8_graph_ms"],
        "library_graph_ms": mm["int8_library_graph_ms"],
        "gb_per_s": mm["int8_gb_per_s"],
        "bf16_ms": mm["bf16_ms"],
        "bf16_plain_ms": mm["bf16_plain_ms"],
        "bf16_bound_ms": mm["bf16_bound_ms"],
        "bf16_library_ms": mm["bf16_library_ms"],
        "bf16_graph_ms": mm["bf16_graph_ms"],
        "bf16_library_graph_ms": mm["bf16_library_graph_ms"],
        "bf16_gb_per_s": mm["bf16_gb_per_s"],
    }, {
        "name": "wavenet_variant",
        "route": "cuda",
        "source": "parallelwavegan_torch/csrc/wavenet_variant.cu",
        "replaces": "tools/int8_wavenet_experiment.py:53",
        "launches": variant["launches"],
        "max_abs_err": max(variant["err"], worst_new["wavenet_variant"]),
        "max_rel_err": REL_ERR.get("wavenet_variant", 0.0),
        "ms": variant["tool"]["wavenet_variant_bf16_ms"],
        "plain_ms": variant["plain_ms"],
        "bound_ms": variant["bound_ms"],
        "bound_by": variant["bound_by"],
        "library_ms": None,
        "plan": variant["variants"]["bf16_tanh"]["plan"],
        "bytes_floor_ms": variant["variants"]["bf16_tanh"]["bytes_floor_ms"],
        "variants": variant["variants"],
        "baseline_ms": variant["tool"]["wavenet_bf16_baseline_ms"],
        "tanh_over_baseline": variant["tanh_over_baseline"],
        "snr_db": variant["snr_db"],
    }]
    # step 12 (g), step 13 (h), step 14 (f), step 15 (f): none of the five
    # runs on the StyleMelGAN, the VQ-VAE, the UHiFiGAN or the discrete path
    for entry in kernels:
        entry["style_melgan_launches"] = style["launches"][entry["name"]]
        entry["vqvae_launches"] = vq["launches"][entry["name"]]
        entry["uhifigan_launches"] = uh["launches"][entry["name"]]
        entry["discrete_launches"] = disc["launches"][entry["name"]]
        # step 16 (a): each rank's launches on the data-parallel PWG v1 path
        entry["data_parallel_launches"] = dp["launches"].get(entry["name"])
        # step 17: bin.train and bin.decode through the stage runner
        entry["recipe_launches"] = rl[entry["name"]]
        # step 18: bin.train.run on the native loader
        entry["native_loader_launches"] = nl[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    sys.exit(main())
