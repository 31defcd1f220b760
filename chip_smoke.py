#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. build    compile every CUDA source of ``wavjepa_tpu_torch/csrc`` with nvcc
            (one process each, all at once), print the card and its power
            limit, ptxas's register and spill report, and the count of
            wgmma instructions (``HGMMA`` in ``cuobjdump -sass``) in each
            library and, in the backward's, in each bf16 kernel function:
            none in a flash or fused library, or in a bf16 backward kernel
            (the one-pass kernel and both two-pass kernels), fails the run;
2. kernels  hold each kernel against its plain PyTorch version on the card at
            the shapes the serving and training paths give it, in bf16 and
            f32, and time kernel, plain version, one PyTorch library call,
            and the bound; also where the kernels change tile or route (the
            forward at T = 64, 65 and 999, the backward at T = 128 and past
            it on its two-pass route up to T = 400), each row naming the
            route it took;
            the backward also with a fully masked row, whose dq must be
            non-zero and equal the plain version's, and twice with equal
            bits; the fused
            block (forward and backward, weight gradients too) likewise at
            the decoder's, the encoder's and serving's shapes, its backward
            also at the unpacked 200-token encoder (its core on the two-pass
            route) and twice with equal bits; and the fused block's bf16 product alone
            (``csrc/hopper_gemm.cu``) against ``torch.matmul`` at the QKV and
            weight-gradient products of the decoder batch and serving's QKV
            product, both timed in turns, in TFLOP/s; and the fused
            residual-add + LayerNorm32 (``csrc/layer_norm.cu``), forward and
            backward, bf16 and f32, with and without a residual, at the main
            paths' row counts, its backward twice with equal bits, timed
            beside its bound, its plain versions and ``F.layer_norm``; and
            WavLM's gated relative-position bias in the flash forward
            (``relbias_flash``, through ``relbias_attention``), bf16 and f32,
            against its plain version at a WavLM request's shapes (16, 16,
            1749 and 880, 64) and at T = 1, 63, 65 and 129, with padded,
            scattered and fully masked keys, and with a zero bias against
            the unbiased kernel; timed at the request shapes beside its
            bound, the plain version and the library route (the bias
            materialised, then SDPA);
3. serve    load the HEAR runtime at base width with seeded random weights
            and answer requests: scene embeddings of 8 clips of 10 s,
            timestamp embeddings of a ragged batch (1.0, 2.01, 4.3, 30 s) and
            of one clip of exactly one window (32159 samples), and the whole-clip config (T=999) on
            4 clips of 10 s; check shapes, finiteness and that the attention
            kernel ran exactly once per encoder layer per request, and
            the norm kernel 2·layers + 2 times (no backward);
3b. serve fused  the same requests and weights with ``attn_impl="fused_block"``:
            the fused forward once per encoder layer, flash attention never,
            and embeddings within 5e-2 (relative Frobenius) of phase 3's;
            then both paths timed in turns on the same clips;
3c. serve wavlm  WavLM Large (seeded weights, bf16, f32 norms) through
            ``api/hear_wavlm``: one request of 16 utterances padded to the
            longest, 35 s (1,749 frames); the biased kernel exactly once a
            layer, the norm kernel 2·layers + 2 times, no unbiased flash
            forward; finite scene and timestamp embeddings, each utterance's
            averaged frames as the frontend counts them; the request timed;
4. parity   the same weights in f32 on the card (TF32 off) and on the CPU, and
            bf16 on the card against that f32 result;
5. train    ``train_jepa`` on the AudioSet configuration as resolved (base
            width, 32 clips × 8 crops, bf16, packing 88/128, 16 microbatches)
            on synthetic clips for a few steps; check finite losses, the
            teacher moving less than the student, exactly 36·a forward and
            24·a backward kernel launches a step (a microbatches), the
            checkpoint and its model_config.json, and a HEAR request served
            from that checkpoint (bf16, unpacked); then a few steps in one
            pass (accum 1), where the predictor is replayed in the backward
            as the JAX package resolves recomputation: 48 forward launches;
            the norm kernel 75 forward and 51 backward launches a
            microbatch (99 and 51 at accum 1);
5b. train fused  the same with ``trainer.attn_impl_decoder=fused_block``:
            12·a fused forward and backward launches a step, 24·a flash
            forward and 12·a flash backward, and the override kept in the
            checkpoint's model_config.json;
6. train parity  one step from the same injected crops and masks at base
            width in f32 on the card (TF32 off) and on the CPU, and in bf16
            on the card against that f32 step;
6b. train parity fused  the same with ``attn_impl="fused_block"`` (encoder,
            teacher and predictor), and its f32 loss against phase 6's;
7. data     write WebDataset shards of 10-s WAV clips (44.1 kHz stereo and
            16 kHz mono) under ``build/chip_smoke_shards/``; hold the native
            resampler against scipy's at 44.1k and 48k → 16k; time one
            worker's work a clip; then ``train_jepa`` from the shards at
            accum 16 and accum 1 with phase 5's checks and the time each
            step waited for its batch; the loader at 16 worker processes as
            it primed for the first of them (its first batch, the clips a
            second it produced) beside the clips a second the card consumes
            in phase 5; and the CLI (``python -m wavjepa_tpu_torch.train
            data.data_dirs=...``, its ``main`` in this process);
8. trace    one accum-16 and one accum-1 step under ``torch.profiler``
            (``build/chip_smoke_trace/*.json.gz``): wall time, the card's idle
            share, kernels launched, the top kernels and host operators;
            and the MFU of phases 5 and 7;
9. nat      WavJEPA-Nat (``configs/nat_binaural.yaml``, 2 channels, base
            width): one scene batch at the real shape (32 clips of 10 s at
            32 kHz, 2-s binaural RIRs, 5 noise sources) synthesized on the
            card against the CPU and resampled to 16 kHz against scipy (TF32
            on in the process), their times and the convolution pair's at
            four FFT lengths; ``train_jepa`` on synthetic scene batches at
            accum 16 with phase 5's checks and the scene build's share of
            the step; one f32 Nat step card against CPU (phase 6's); then
            ``train_jepa`` from shards written under ``build/`` (clean
            clips, binaural RIR and noise .npy tars) with the device banks
            and one refresh a batch; and the Nat HEAR runtime
            (``api/hear_natjepa``: binaural scene and timestamp requests, a
            4-channel request, f32 card against CPU, bf16 against f32);
9b. ambisonic  WavJEPA-Nat at 4 channels (``configs/nat_binaural.yaml`` with
            ``data.in_channels=4 extractor.pos_embed=time``, base width):
            the flash shapes it resolves to (packing 352/512, the teacher on
            800 tokens, 16 microbatches) against those phase 2 holds; the
            step's scene build from a 4-channel batch at the real shape;
            ``train_jepa`` on synthetic 4-channel scene batches with phase
            5's checks (exactly 36 forward and 24 backward launches a
            microbatch, both backwards on the two-pass route), its step
            p50, MFU, peak memory and the scene build's share; one f32 step
            card against CPU and bf16 against it (phase 6's); ``train_jepa``
            from shards with 4-channel RIR stacks, the device banks and one
            refresh a batch; and the first run's checkpoint served by
            ``api/hear_natjepa.load_model`` (2 four-channel clips of 10 s,
            f32 card against CPU, bf16 against f32);
9c. microbatch graph  the Nat configuration as its benchmark cell runs it
            (base width, 32 clips × 8 crops, 16 microbatches) through
            ``build_run``: steps through the train step's microbatch graph
            (each microbatch's forward and backward replayed as one CUDA
            graph) and through the eager loop in turns, timed, with the
            card's memory; then one step a route from one state with the
            gathers' backward deterministic: loss, gradient norm, every
            gradient, weight, teacher leaf and AdamW moment bit for bit
            equal, each counted wrapper's launches equal on both routes and
            exactly a Nat microbatch's a microbatch, one capture and 15
            replays counted;
10. denoise  denoise distillation at the CLI's defaults (base width, bf16,
            8 clips × 16 crops, 4 microbatches, α = 0): a seeded JEPA
            written as a port checkpoint under ``build/`` and loaded as the
            teacher; ``train_denoiser`` on synthetic scene batches with
            finite losses, the first step's loss_clean below 1e-6 (the
            warm-started student is the teacher), the teacher bitwise
            unchanged, exactly 36·a flash forward and 12·a backward
            launches a step on the two-pass route, its step p50, clips/s,
            crops/s, MFU and peak memory; 3 steps at α = 0.5 (24·a
            backward); one traced step (phase 8's reading); one f32 step
            card against CPU and bf16 against it;
            ``train_denoiser`` from phase 9's shards with device banks (the
            RIR's first channel); the CLI (its ``main`` in this process); and the
            distilled student's checkpoint served by ``load_model``;
11. eval     the HF-style surface (``api/hf.py``) on phase 5's checkpoint: the
            feature extractor on a 10-s clip at 44.1 kHz and at 16 kHz into
            ``WavJEPAForAudioEmbeddings``, whose embeddings must equal
            ``load_model``'s bit for bit, and a 2-channel Nat request;
            ``api/hear_wavjepa_w2v2`` (seeded weights): scene 8 × 10 s,
            ragged timestamps (1.0, 4.02, 4.3, 30 s) and one window exactly
            (64319 samples), 200 tokens a window and 20-ms steps, f32 card
            against CPU and bf16 against f32; then the HEAR harness: two
            synthetic 16-kHz tasks under ``build/chip_smoke_hear/`` at the
            size of public HEAR tasks (ESC-50: 2000 tones of 5 s, 50
            classes, 5 folds; DCASE 2016 task 2's clips of 120 s with 30
            tone events each, 11 labels, 24 of its 72), the embeddings runner
            with ``api/hear_wavjepa`` in-process, ``predictions --grid
            faster`` with the probes on the card, the on-disk contract,
            clips/s, audio-s/s, peak memory and probe ms an epoch, and both
            CLIs (their ``main`` in this process) on a small task. Each
            path: 12 flash forwards an encoder forward, no other kernel;
12. arch/xares  the ARCH recipe on ESC-50 written at its size under
            ``build/chip_smoke_arch/`` (2000 clips of 5 s, 44.1 kHz mono
            PCM16, 50 classes, 5 folds): ``ESC50(path).evaluate`` of a
            ``WavJEPAModel`` (seeded weights) in the linear, non-linear and
            attention-pooling modes over all folds (each clip decoded and
            resampled to 16 kHz on the host, embedded in batches of 32, the
            probes on the card; epochs cut to 10, 10 and 3), the ARCH CLI
            (its ``main`` in this process) on a 48-clip layout; then X-ARES:
            ``check_audio_encoder`` on the default and a ``fused_block``
            runtime, the encoder's request at (4, 10 s), ``run_stub_task``,
            ``run_task_protocol`` of ``config_esc50`` on 400 in-memory 5-s
            clips and of ``config_fsd50k`` (multilabel, 10-s clips); the f32
            encoder on the card against the CPU. Embeddings finite, of the
            contract's shapes; every metric finite and in range (printed, not
            gated: random weights); 12 flash forwards an encoder forward, the
            fused forward on the fused check, no other kernel;
13. parallel  data parallelism: (a) the train CLI on the AudioSet
            configuration (3 steps) and the denoise CLI at its
            defaults (2 steps) under ``torch.distributed.run --standalone
            --nproc_per_node=1`` over NCCL, as this file's worker rank
            (``--parallel-worker torchrun_cli``) that calls each CLI's
            ``main`` with its launches counted: exit 0, one writer's files,
            the step p50 beside phase 5's spread (at world size 1 the step
            issues no collective), the denoise student served by
            ``load_model``, and the gradient all-reduce of the base model
            (0.44 GB of f32) timed alone on that NCCL group; (b) two ranks on the
            one card in a gloo group made here (``--parallel-worker gloo``;
            NCCL takes one rank a card), 8 clips a step at accum 2 (phase 5's
            accum-16 microbatch shapes a rank), 2 f32 steps, 2 bf16 steps
            and one Nat step, against one process at the same seed: f32
            losses and gradient norms within phase 6's limits, weights and
            teacher bit for bit equal on both ranks, the bf16 and Nat loss
            differences printed;
14. tensor parallel  (a) ``train_jepa`` on configs/large.yaml as resolved
            (24 × 1024 encoder, 12 × 384 predictor, 8 clips × 8 crops in
            bf16, one pass, the predictor replayed) at world size 1: its
            step p50, clips/s, MFU, peak memory, exactly 72 flash forward
            and 36 backward launches a step, and a HEAR request served from
            its checkpoint; (b)
            ``trainer.model_parallel=2`` as two gloo ranks on the one card
            (``--tp-worker``) at the large widths, depth cut to 4 + 2
            layers, against one process at the same seed: 3 f32 steps
            within phase 6's limits and step-1 gradients leaf by leaf at
            rtol 1e-5, atol 1e-6, replicated leaves and whole weights bit
            for bit equal on both ranks, 3 bf16 steps and one fused-block
            step with their differences, the flash kernels at 8 and 6 local
            heads and the fused ones at A = 512 and 192, and on the ranks
            alone one f32 step with every stack replayed (phase 15(d)).
            Phase 2 also holds the fused kernels at those rank shapes
            (``FUSED_TP_SHAPES``);
15. recomputation  ``trainer.remat*`` beside phase 5's accum-1 run (the JAX
            package's resolution, the predictor replayed): (a) the AudioSet
            configuration at accum 1 with ``trainer.remat=false``, with
            every stack replayed, and with that and
            ``trainer.remat_save_probs=true`` (the attention core kept):
            step p50, clips/s, crops/s, MFU, peak memory and exactly 36, 60
            and 36 flash forward launches a step (24 backward); (b) one f32
            step at base width with every stack replayed beside one without,
            from the same state and batch, on the default path and with
            ``attn_impl=fused_block``: the loss bit for bit equal, the
            updated weights and the gradient norm within phase 6's limits,
            the kernels' launches counted; (c) configs/large.yaml at 32 × 8
            crops in one pass with every stack replayed through
            ``train_jepa``: step p50, MFU, peak memory below the card's,
            beside the peak that one 64-crop step without recomputation
            implies for 256 crops; (d) phase 14(b)'s two gloo ranks at
            ``model_parallel=2``: the replayed f32 step's step-1 gradients
            against the one process's at 14(b)'s rtol and atol.
16. librispeech  ``configs/librispeech.yaml`` (the wav2vec2 frontend, the
            speech masker, unpacked tokens) from FLAC shards: (a) shards in
            LibriSpeech's layout (8 × 8 utterances of 16 kHz mono, 1.5-35 s)
            and AudioSet's (8 × 4 clips of 10 s, 44.1 kHz stereo) written by
            the port's FLAC writer, every payload decoded bit for bit by the
            native library built on this host, one worker's ms a clip for
            FLAC against WAV of the same samples; (b) the train CLI on the
            file, 3 steps at 64 × 8 crops in 16 microbatches: finite
            losses, the teacher moved less
            than the student, exactly 48 forward and 24 backward flash
            launches a microbatch (the frontend and the encoder replayed),
            step p50, clips/s, crops/s, MFU, peak memory, data wait, the
            checkpoint's sidecar (wav2vec2 spec, 100 tokens) and a HEAR
            request served from it; (c) ``train_jepa`` on its 4.02-s form
            (200 tokens, the backward's two-pass route), 2 steps; (d) phase
            6's injected step at the recipe's configuration, f32 card
            against CPU and bf16 against f32; (e) ``train_jepa`` on the
            AudioSet configuration from the AudioSet-layout FLAC shards,
            with phase 7's priming record, 2 steps. Phase 2 holds the
            kernels at the recipe's microbatch shapes (``LIBRI_ATTN_SHAPES``).

It imports nothing of JAX. The last lines of standard output are the card's
name and power limit, the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``; the full record goes to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import faulthandler
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    # the data workers of phase 7 are spawned, and each re-runs this file as
    # "__mp_main__": they decode audio and need no torch
    import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
BF16_ATOL = 1e-2   # bf16 output: ~1 ulp at |o| < 2, plus P rounded in another order
F32_ATOL = 1e-5    # f32: the same maths, summed in another order
CARD_CPU_ATOL = 1e-3  # f32 model, card vs CPU, 12 layers of reordered sums
BF16_REL_FRO = 5e-2   # bf16 model vs f32 model on the card, relative Frobenius
# kernel vs plain version at the training shapes, relative to max(1, max |plain|):
# bf16 about one bf16 ulp of the largest value (P and dS are rounded to bf16
# before their products, in another order); f32 the same maths summed in
# another order
BF16_REL = 1e-2
F32_REL = 1e-5
# one train step, f32, card vs CPU (same weights, crops and masks): the loss
# and gradient norm after 24 layers of reordered f32 sums; each weight after
# AdamW's first step, which moves it by lr·g/(|g|+eps), so a gradient that
# differs by its f32 noise moves it by a small share of lr; the teacher, an
# EMA of equal weights, only by rounding
STEP_LOSS_REL = 1e-4
STEP_GRAD_NORM_REL = 1e-3
STEP_PARAM_ATOL_LR = 0.1  # × lr
STEP_TEACHER_ATOL = 1e-6
STEP_BF16_LOSS_REL = 5e-2  # bf16 step vs f32 step on the card, loss
# train phase: steps (cut from 6 for the script's time), and those left out
# of the p50
TRAIN_STEPS, TRAIN_WARMUP = 5, 2
TRAIN_STEPS_ONE_PASS = 3
# the counted wrappers (launch_counters), and the launches a step of the
# base model in one pass with its predictor replayed in the backward, as the
# JAX package resolves recomputation at accum 1: 12 layers each of the
# student encoder, the teacher and the predictor forward, the predictor's
# again, the student encoder and the predictor backward
COUNTER_NAMES = ("flash_attention_fwd", "flash_attention_bwd", "fused_attention_block_fwd",
                 "fused_attention_block_bwd")
DECODER_REPLAYED = dict(zip(COUNTER_NAMES, (48, 24, 0, 0)))
# the fused block against its plain version, relative to max(1, max |plain|):
# bf16 two roundings (qkv, then o) ahead of the last product, each of which
# the plain version may round the other way, then the output's own rounding;
# f32 four chained products and weight gradients summed over up to 131k rows,
# in another order
FUSED_BF16_REL = 2e-2
FUSED_F32_REL = 1e-4
FUSED_PATH_LOSS_REL = 1e-4  # f32 step, fused path vs the default path, loss

# phase 7: 16 shards (one a worker at the default 16 workers) of 4 WAV PCM16
# clips of 10 s, 3 at 44.1 kHz stereo (mono-ized, then resampled to 16 kHz)
# and 1 at 16 kHz mono: 64 distinct clips, which the repeating shard stream
# reads again and again to fill the default 1000-clip shuffle buffer
DATA_SHARDS, DATA_CLIPS_PER_SHARD = 16, 4
DATA_DIR = os.path.join("build", "chip_smoke_shards")
LOADER_PRIME_S = 60.0  # at most, to fill the loader's queue before a shard-fed run
RESAMPLE_ATOL = 2e-6  # native resampler vs scipy's resample_poly, audio in [-1, 1]
CLI_STEPS = 2
# the train CLI's shuffle buffer in phase 7, cut from the default 1000 clips
# for the script's time (its fill, ~5 s of the run, is timed by the
# shard-fed runs before it)
CLI_SHUFFLE_BUFFER = 256
# WavJEPA-Nat's configuration file (phases 9, 9b and 13(b))
NAT_RECIPE = "configs/nat_binaural.yaml"
# each Nat run (phases 9 and 9b): 1 warm-up step and 3 timed (phase 9's cut
# from 5 steps for the script's time)
NAT_STEPS, NAT_WARMUP = 4, 1
# phase 9 (WavJEPA-Nat): one scene batch of the Nat configuration (32 clips
# of 10 s at 32 kHz, 2-s binaural RIRs, 5 noise sources); the scenes on the
# card against the same code on the CPU (the convolutions as in
# tests/test_torch_nat_scenes.py, relative to max(1, max |CPU|)) and the
# resampler against scipy's resample_poly (f32 sums in another order, on
# scenes of a few units)
NAT_SCENE_REL = 1e-4
NAT_RESAMPLE_REL = 1e-5
# FFT lengths for the scene convolution pair at T = 320000, L = 64000 (n >=
# 383999): the port's 7-smooth rule, the JAX package's multiple of 4096
# (94 · 4096 = 2^13 · 47), 2^17 · 3 and the next power of two
NAT_FFT_LENGTHS = (384000, 385024, 393216, 524288)
NAT_SHARDS_DIR = os.path.join("build", "chip_smoke_nat_shards")
NAT_RIR_STACKS, NAT_NOISE_ROWS = 64, 32
# serving: binaural clips, the contract's tolerances (phase 4's)
# phase 8: one traced step at accum 16 and one at accum 1, after warm-up steps
TRACE_DIR = os.path.join("build", "chip_smoke_trace")
# phase 10 (denoise): its checkpoints, the teacher's seed, the steps of the
# α = 0 runs (synthetic, shards) and of the α = 0.5 run; at step 1 the
# warm-started student is the teacher, so the clean view's loss is 0 but
# for the order of bf16 sums
DENOISE_DIR = os.path.join("build", "chip_smoke_denoise")
DENOISE_TEACHER_SEED = 7
DENOISE_STEPS, DENOISE_STEPS_BLEND = 6, 3
DENOISE_FIRST_LOSS_CLEAN = 1e-6
TRACE_WARMUP = 2
# phase 11 (eval): phase 5's checkpoint kept for the HF surface, the HEAR
# tasks and their embeddings; the wav2vec2 frontend's 200 tokens a 4.02-s
# window are 20-ms steps on the integer-second grid (50 Hz), to within 1%
EVAL_DIR = os.path.join("build", "chip_smoke_eval")
HEAR_DIR = os.path.join("build", "chip_smoke_hear")
W2V2_STEP_MS, W2V2_STEP_REL = 20.0, 0.01
# grid points of predictions --grid faster a task: all 8 for the scene task;
# 1 for the event task, whose 36 train clips of 120 s are ~430k probe rows
# (~420 steps an epoch; cut from 2 for the script's time)
HEAR_GRID_POINTS = {"scene": 8, "event": 1}
# DCASE 2016 task 2's layout at a third of its clips (24 of 72 clips of 120
# s, split 12/6/6; ~143k probe rows of its 429876), cut for the script's time
HEAR_EVENT_SPLITS = (("train", 12), ("valid", 6), ("test", 6))
# phase 12 (ARCH and X-ARES): ESC-50 at its size under build/ (~880 MB of
# 44.1-kHz PCM16, deleted at the end); the probes' epochs a mode, cut for time
# from the CLI's 100; the in-memory X-ARES clips (train, test) a task
ARCH_DIR = os.path.join("build", "chip_smoke_arch")
ARCH_EPOCHS = {"linear": 10, "non-linear": 10, "attention-pooling": 3}
XARES_CLIPS = {"esc50": (300, 100), "fsd50k": (160, 80)}
XARES_REQUEST = (4, 10.0)  # the encoder request timed: 4 clips of 10 s
# a run still going after this many seconds prints every thread's stack and
# exits non-zero; give the run a time limit above it (1,800 s). Whole runs
# took 908-1,022 s before WavLM's phases; host speed
# moves the host-bound phases by up to 40% between NVIDIA H100 80GB HBM3
# machines at 700 W (PERF.md, section 4)
WATCHDOG_S = 1500

# (name, B, H, T): the windowed batch of 8 clips of 10 s (40 windows of 200
# tokens), the whole-clip batch of 4 clips of 10 s (each gains a fully padded
# second window: 8 rows of 999), 4 whole clips, and the large model's heads
ATTN_SHAPES = [
    ("windowed", 40, 12, 200),
    ("whole_clip", 8, 12, 999),
    ("whole_clip_b4", 4, 12, 999),
    ("large_windowed", 4, 16, 200),
    ("nat_windowed", 40, 12, 400),  # WavJEPA-Nat: 8 binaural clips, 2 × 200 tokens a window
    ("w2v2_windowed", 24, 12, 200),  # the wav2vec2 frontend: 8 clips of 10 s, 3 windows of 4.02 s
    ("arch_windowed", 96, 12, 200),  # ARCH's ESC-50 batch: 32 clips of 5 s, 3 windows each
]
HEAD_DIM = 64
# (name, B, T, D, heads) of the fused block: the packed decoder (4 groups a
# crop) for one of 16 microbatches and for the whole batch (head_dim 32),
# serving's windowed and whole-clip batches, the packed student encoder's
# microbatch (head_dim 64) and the large model's windowed batch (16 heads of
# 64); the backward also at a T that is not a multiple of the 64-row tiles,
# and at an odd number of rows, which leaves the weight gradients' last
# 32-row slice part empty
FUSED_FWD_SHAPES = [
    ("decoder_mb", 64, 128, 384, 12), ("decoder", 1024, 128, 384, 12),
    ("windowed", 40, 200, 768, 12), ("whole_clip", 8, 999, 768, 12),
    ("student_encoder_mb", 16, 88, 768, 12), ("large_windowed", 4, 200, 1024, 16),
    # the ambisonic Nat predictor's microbatch under
    # trainer.attn_impl_decoder=fused_block (its core's backward at T = 512)
    ("ambisonic_decoder_mb", 64, 512, 384, 12),
]
FUSED_BWD_SHAPES = [
    ("decoder_mb", 64, 128, 384, 12), ("decoder", 1024, 128, 384, 12),
    ("student_encoder_mb", 16, 88, 768, 12), ("ragged_t100", 16, 100, 768, 12),
    ("odd_rows", 3, 99, 384, 12),
    # the unpacked 200-token encoder: its core takes the two-pass route
    ("unpacked_encoder_t200", 16, 200, 768, 12),
    ("ambisonic_decoder_mb", 64, 512, 384, 12),
]
# (name, B, T, D, heads, head_dim) of a tensor-parallel rank's block at
# trainer.model_parallel=2 on the large configuration: a subset of the heads,
# attention width A = heads·head_dim below D, and no output bias (the
# transformer adds it after the ranks' sum). The packed student encoder's
# microbatch (8 of 16 heads of 64, A = 512) and the packed decoder's (6 of
# 12 heads of 32, A = 192: dWo is 384 × 192, not a whole number of 128-wide
# tiles); forward and backward
FUSED_TP_SHAPES = [
    ("tp2_large_encoder_mb", 16, 88, 1024, 8, 64), ("tp2_decoder_mb", 64, 128, 384, 6, 32),
]
# a microbatch of configs/librispeech.yaml (32 crops, unpacked): the encoder
# (B, H, T, d) and the predictor (4 groups a crop), at 2.01 s and at 4.02 s
LIBRI_ATTN_SHAPES = [
    ("librispeech_encoder_mb", 32, 12, 100, 64), ("librispeech_decoder_mb", 128, 12, 100, 32),
    ("librispeech_402_encoder_mb", 32, 12, 200, 64),
    ("librispeech_402_decoder_mb", 128, 12, 200, 32),
]
# a microbatch of the ambisonic Nat configuration (configs/nat_binaural.yaml
# with AMBISONIC; 16 microbatches of 16 crops): the packed student encoder
# (B, H, T, d), the packed predictor (4 groups a crop) and the teacher on all
# 800 tokens; phase 9b checks them against the configuration as resolved
AMBISONIC_ATTN_SHAPES = [
    ("ambisonic_student_encoder_mb", 16, 12, 352, 64), ("ambisonic_decoder_mb", 64, 12, 512, 32),
    ("ambisonic_teacher_mb", 16, 12, 800, 64),
]
# the training path's attention, AudioSet configuration (256 crops): the
# packed student encoder, the packed decoder (4 groups a crop) and the
# teacher, for the whole batch and for one of its 16 microbatches; the
# backward also at a T that is not a multiple of the kernel's 64-row tiles
TRAIN_FWD_SHAPES = [
    ("student_encoder", 256, 12, 88, 64), ("decoder", 1024, 12, 128, 32),
    ("teacher", 256, 12, 200, 64), ("student_encoder_mb", 16, 12, 88, 64),
    ("decoder_mb", 64, 12, 128, 32), ("teacher_mb", 16, 12, 200, 64),
    # WavJEPA-Nat (configs/nat_binaural.yaml): packing 176/256 over 2 channels,
    # the teacher on all 400 tokens, one of 16 microbatches
    ("nat_student_encoder_mb", 16, 12, 176, 64), ("nat_decoder_mb", 64, 12, 256, 32),
    ("nat_teacher_mb", 16, 12, 400, 64),
    # the denoiser at the CLI's defaults (8 clips × 16 crops, 4 microbatches):
    # the teacher and both student views, unpacked at 200 tokens
    ("denoise_mb", 32, 12, 200, 64),
    # configs/librispeech.yaml (64 clips × 8 crops, 16 microbatches, unpacked):
    # the encoder, its replay and the teacher, and the 4-group predictor, at
    # 2.01 s (100 tokens) and at 4.02 s (200)
    *LIBRI_ATTN_SHAPES,
    *AMBISONIC_ATTN_SHAPES,
]
TRAIN_BWD_SHAPES = [
    ("student_encoder", 256, 12, 88, 64), ("decoder", 1024, 12, 128, 32),
    ("student_encoder_mb", 16, 12, 88, 64), ("decoder_mb", 64, 12, 128, 32),
    ("ragged_t100", 16, 12, 100, 64),
    # WavJEPA-Nat's trained stacks, above T = 128: the two-pass route
    ("nat_student_encoder_mb", 16, 12, 176, 64), ("nat_decoder_mb", 64, 12, 256, 32),
    # the denoiser's student, unpacked at 200 tokens: the two-pass route
    ("denoise_mb", 32, 12, 200, 64),
    # configs/librispeech.yaml's encoder and predictor: one pass at 100
    # tokens, two passes at 200
    *LIBRI_ATTN_SHAPES,
    # the ambisonic Nat encoder and predictor: two passes at 352 and 512
    *AMBISONIC_ATTN_SHAPES[:2],
]
# where the kernels change tile or route: the forward at one 64-row tile and
# one row past it, and the whole clip at head_dim 32; the backward at the
# largest T of its one-pass kernel (128) and past it, where the two-pass
# kernels take over (129, the unpacked 200-token encoder, and 400)
EDGE_FWD_SHAPES = [
    ("edge_t64", 16, 12, 64, 64), ("edge_t65", 16, 12, 65, 32),
    ("edge_t999_d32", 4, 12, 999, 32),
]
EDGE_BWD_SHAPES = [
    ("edge_t128_d64", 16, 12, 128, 64), ("edge_t129", 16, 12, 129, 64),
    ("edge_t129_d32", 16, 12, 129, 32), ("unpacked_encoder_t200", 16, 12, 200, 64),
    ("edge_t400", 4, 12, 400, 64),  # the two-pass route past the main paths' T
]
# the backward's bf16 kernels, each built at d = 32 and 64, that must run on
# wgmma: the one-pass kernel (T ≤ 128) and both passes above it
BWD_WGMMA_KERNELS = ("bwd_single_pass_bf16", "bwd_dq_bf16", "bwd_dkdv_bf16")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b: int, h: int, t: int, d: int, elem: int) -> tuple[float, str]:
    """Least time for the work: q, k, v read once, o written once, the mask
    read once, against 4·B·H·T²·d operations (QKᵀ and PV)."""
    bytes_moved = 4 * b * h * t * d * elem + b * t
    ops = 4 * b * h * t * t * d
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bwd_bound(b: int, h: int, t: int, d: int, elem: int) -> tuple[float, str]:
    """Least time for the backward: q, k, v, dO read once, dq, dk, dv
    written once, the mask and the (B, H, T, 2) f32 row statistics read once,
    against 10·B·H·T²·d operations (the recomputed QKᵀ, dO·Vᵀ, Pᵀ·dO, dS·K,
    dSᵀ·Q)."""
    bytes_moved = 7 * b * h * t * d * elem + b * t + 8 * b * h * t
    ops = 10 * b * h * t * t * d
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def scaled_err(out: torch.Tensor, ref: torch.Tensor, rel: float) -> tuple[float, bool]:
    """max |out − ref| and whether it is within rel · max(1, max |ref|)."""
    err = (out.float() - ref.float()).abs().max().item()
    return err, err <= rel * max(1.0, ref.float().abs().max().item())


def card_inputs(b, h, t, d, seed, n=3):
    """n (B, H, T, d) normal tensors and a (B, T) mask drawn on the card,
    with a fully masked first row and a clean last row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn(b, h, t, d, generator=g, device="cuda") for _ in range(n)]
    mask = torch.rand(b, t, generator=g, device="cuda") < 0.3
    mask[0] = True
    mask[-1] = False
    return xs, mask


def phase_kernels(fa) -> list[dict]:
    from wavjepa_tpu_torch.ops.flash_attention import flash_attention_reference

    results = []
    for i, (name, b, h, t) in enumerate(ATTN_SHAPES):
        (q, k, v), mask = card_inputs(b, h, t, HEAD_DIM, seed=i)
        row = {"shape": name, "B": b, "H": h, "T": t, "d": HEAD_DIM, "route_bf16": "wgmma"}
        for dtype, atol, key in ((torch.float32, F32_ATOL, "f32"),
                                 (torch.bfloat16, BF16_ATOL, "bf16")):
            qq, kk, vv = (x.to(dtype) for x in (q, k, v))
            out = fa(qq, kk, vv, mask)
            ref = flash_attention_reference(qq, kk, vv, mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out).all() or not err <= atol:
                raise AssertionError(f"{name} {key}: max |kernel - plain| {err} > {atol}")
            row[f"max_abs_err_{key}"] = err
            if dtype == torch.float32:  # fully masked row = mean of v over real keys
                uni = vv[0].mean(dim=1, keepdim=True).expand_as(vv[0])
                uerr = (out[0] - uni).abs().max().item()
                if not uerr <= 1e-5:
                    raise AssertionError(f"{name}: fully masked row not uniform ({uerr})")
        qq, kk, vv = (x.to(torch.bfloat16) for x in (q, k, v))
        keep = ~mask[:, None, None, :]
        row["ms"] = cuda_ms(lambda: fa(qq, kk, vv, mask))
        row["plain_ms"] = cuda_ms(lambda: flash_attention_reference(qq, kk, vv, mask))
        row["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=keep)
        )
        row["bound_ms"], row["bound_by"] = attention_bound(b, h, t, HEAD_DIM, 2)
        print(f"[kernels] flash_attention_fwd {name} (B={b}, H={h}, T={t}, d={HEAD_DIM}): "
              f"err f32 {row['max_abs_err_f32']:.3g} bf16 {row['max_abs_err_bf16']:.3g}; "
              f"bf16 kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        results.append(row)
    return results


def phase_train_kernels() -> tuple[list[dict], list[dict]]:
    """Both kernels against their plain versions at the training shapes."""
    from wavjepa_tpu_torch.ops import flash_attention as fam

    F = torch.nn.functional
    fwd_rows = []
    for i, (name, b, h, t, d) in enumerate(TRAIN_FWD_SHAPES + EDGE_FWD_SHAPES):
        (q, k, v), mask = card_inputs(b, h, t, d, seed=100 + i)
        row = {"shape": name, "B": b, "H": h, "T": t, "d": d, "route_bf16": "wgmma"}
        stats = "teacher" not in name  # the teacher runs without a gradient
        for dtype, rel, key in ((torch.float32, F32_REL, "f32"), (torch.bfloat16, BF16_REL, "bf16")):
            qq, kk, vv = (x.to(dtype) for x in (q, k, v))
            out, _ = fam.flash_attention_fwd(qq, kk, vv, mask, stats)
            ref = fam.flash_attention_reference(qq, kk, vv, mask)
            torch.cuda.synchronize()
            err, ok = scaled_err(out, ref, rel)
            if not torch.isfinite(out).all() or not ok:
                raise AssertionError(f"fwd {name} {key}: max |kernel - plain| {err}")
            row[f"max_abs_err_{key}"] = err
        row["ms"] = cuda_ms(lambda: fam.flash_attention_fwd(qq, kk, vv, mask, stats))
        row["plain_ms"] = cuda_ms(lambda: fam.flash_attention_reference(qq, kk, vv, mask))
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=~mask[:, None, None, :]))
        row["bound_ms"], row["bound_by"] = attention_bound(b, h, t, d, 2)
        row["writes_stats"] = stats
        print(f"[kernels] flash_attention_fwd {name} (B={b}, H={h}, T={t}, d={d}): "
              f"err f32 {row['max_abs_err_f32']:.3g} bf16 {row['max_abs_err_bf16']:.3g}; "
              f"bf16 kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        fwd_rows.append(row)

    bwd_rows = []
    for i, (name, b, h, t, d) in enumerate(TRAIN_BWD_SHAPES + EDGE_BWD_SHAPES):
        (q, k, v, do), mask = card_inputs(b, h, t, d, seed=200 + i, n=4)
        row = {"shape": name, "B": b, "H": h, "T": t, "d": d,
               "route_bf16": fam.flash_attention_bwd_route(t, d, torch.bfloat16)}
        for dtype, rel, key in ((torch.float32, F32_REL, "f32"), (torch.bfloat16, BF16_REL, "bf16")):
            qq, kk, vv, dd = (x.to(dtype) for x in (q, k, v, do))
            _, stats = fam.flash_attention_fwd(qq, kk, vv, mask, True)
            grads = fam.flash_attention_bwd(qq, kk, vv, mask, dd, stats)
            again = fam.flash_attention_bwd(qq, kk, vv, mask, dd, stats)
            refs = fam.flash_attention_bwd_reference(qq, kk, vv, mask, dd)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(grads, again)):
                raise AssertionError(f"bwd {name} {key}: two calls differ")
            errs = []
            for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
                err, ok = scaled_err(g, r, rel)
                if not torch.isfinite(g).all() or not ok:
                    raise AssertionError(f"bwd {name} {key} {gname}: max |kernel - plain| {err}")
                errs.append(err)
            # the fully masked row: uniform P, so its dq is not zero
            row0_err, ok = scaled_err(grads[0][0], refs[0][0], rel)
            if not ok or refs[0][0].abs().max().item() == 0 or grads[0][0].abs().max().item() == 0:
                raise AssertionError(f"bwd {name} {key}: fully masked row dq wrong ({row0_err})")
            row[f"max_abs_err_{key}"] = max(errs)
            row[f"masked_row_dq_err_{key}"] = row0_err
        row["deterministic"] = True
        row["ms"] = cuda_ms(lambda: fam.flash_attention_bwd(qq, kk, vv, mask, dd, stats))
        row["plain_ms"] = cuda_ms(lambda: fam.flash_attention_bwd_reference(qq, kk, vv, mask, dd))
        # SDPA's backward: autograd through SDPA with the same mask and dO,
        # less SDPA's forward timed in the same turn (derived, not one call)
        qs, ks, vs = (x.detach().requires_grad_(True) for x in (qq, kk, vv))
        keep = ~mask[:, None, None, :]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)

        fwd_ms = cuda_ms(sdpa_fwd)
        both_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), dd))
        row["library_ms"] = both_ms - fwd_ms
        row["library_fwd_bwd_ms"], row["library_fwd_ms"] = both_ms, fwd_ms
        row["bound_ms"], row["bound_by"] = attention_bwd_bound(b, h, t, d, 2)
        print(f"[kernels] flash_attention_bwd {name} (B={b}, H={h}, T={t}, d={d}, bf16 route "
              f"{row['route_bf16']}): err f32 {row['max_abs_err_f32']:.3g} bf16 "
              f"{row['max_abs_err_bf16']:.3g} (masked row dq {row['masked_row_dq_err_bf16']:.3g}), "
              f"bitwise repeatable; bf16 kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa bwd (derived) "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
        bwd_rows.append(row)
    return fwd_rows, bwd_rows


def fused_bound(b: int, t: int, d: int, elem: int, backward: bool,
                a: int = None) -> tuple[float, str]:
    """Least time for the fused block at model width D and attention width
    A (D by default). Forward: x read and out written once, the weights
    (4·D·A) and the mask read once, against 8·B·T·D·A operations for the
    projections and 4·B·T²·A for attention. Backward: x and g read, dx
    written, the weights read and their f32 gradients written, against
    22·B·T·D·A (the recomputed QKV, dO, dx, dWqkv, dWo) and 12·B·T²·A (the
    recomputed Q·Kᵀ and P·V, then dP, dV, dQ, dK)."""
    a = d if a is None else a
    if backward:
        bytes_moved = 3 * b * t * d * elem + 4 * d * a * (elem + 4) + b * t
    else:
        bytes_moved = 2 * b * t * d * elem + 4 * d * a * elem + b * t
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = fused_ops(b, t, d, backward, a) / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fused_ops(b: int, t: int, d: int, backward: bool, a: int = None) -> int:
    """Operations of the fused block: the products and attention."""
    a = d if a is None else a
    if backward:
        return 22 * b * t * d * a + 12 * b * t * t * a
    return 8 * b * t * d * a + 4 * b * t * t * a


def fused_inputs(b, t, d, heads, seed, hd=None):
    """x, the kernel-layout weights (scaled so that activations stay near
    unit size) of ``heads`` heads of ``hd`` (D/heads by default), a mask
    with a fully masked first row and a clean last row, and an upstream
    gradient g, drawn on the card in f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hd = d // heads if hd is None else hd
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    x, grad = rnd(b, t, d), rnd(b, t, d)
    weights = [rnd(heads, d, 3 * hd) / d ** 0.5, 0.1 * rnd(heads, 1, 3 * hd),
               rnd(heads, hd, d) / d ** 0.5, 0.1 * rnd(1, d)]
    mask = torch.rand(b, t, generator=g, device="cuda") < 0.3
    mask[0] = True
    mask[-1] = False
    return x, weights, mask, grad


def phase_fused_kernels() -> tuple[list[dict], list[dict]]:
    """The fused block's kernels against their plain versions, and against
    one library chain: F.linear, SDPA with the same boolean mask, F.linear
    (the port never calls it)."""
    from wavjepa_tpu_torch.ops import fused_attention_block as fab
    from wavjepa_tpu_torch.ops.flash_attention import flash_attention_bwd_route

    F = torch.nn.functional

    def torch_layout(wqkv, bqkv, wo, bo):
        """The block's weights as the torch module holds them, which is how
        the kernels and F.linear take them (no output bias: None)."""
        return [None if w is None else w.contiguous()
                for w in (*fab.unpack_weights(wqkv, bqkv, wo),
                          None if bo is None else bo.reshape(-1))]

    def library_chain(x, w_in, b_in, w_out, bo, keep, heads):
        b, t, _ = x.shape
        a = w_in.shape[0] // 3
        qkv = F.linear(x, w_in, b_in).view(b, t, 3, heads, a // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        return F.linear(o.transpose(1, 2).reshape(b, t, a), w_out, bo)

    def check(name, key, outs, refs, rel, row):
        """Records max |kernel − plain| over the outputs, and its largest
        ratio to max(1, max |plain|) of the same output; raises past rel."""
        errs, ratios = [], []
        names = ("out",) if len(outs) == 1 else ("dx", "dw_in", "db_in", "dw_out", "db_out")
        for gname, o, r in zip(names, outs, refs):
            err, ok = scaled_err(o, r, rel)
            if not torch.isfinite(o).all() or not ok or o.shape != r.shape:
                raise AssertionError(f"{name} {key} {gname}: max |kernel - plain| {err}")
            errs.append(err)
            ratios.append(err / max(1.0, r.float().abs().max().item()))
        row[f"max_abs_err_{key}"], row[f"scaled_err_{key}"] = max(errs), max(ratios)

    fwd_rows = []
    for i, (name, b, t, d, heads, *tp) in enumerate(FUSED_FWD_SHAPES + FUSED_TP_SHAPES):
        hd = tp[0] if tp else d // heads
        a = heads * hd  # < D: a tensor-parallel rank's heads, no output bias
        x, weights, mask, _ = fused_inputs(b, t, d, heads, seed=300 + i, hd=hd)
        row = {"shape": name, "B": b, "T": t, "D": d, "H": heads, "hd": hd, "A": a}
        for dtype, rel, key in ((torch.float32, FUSED_F32_REL, "f32"),
                                (torch.bfloat16, FUSED_BF16_REL, "bf16")):
            xx, (w1, b1, w2, b2) = x.to(dtype), [w.to(dtype) for w in weights]
            if a < d:
                b2 = None
            params = torch_layout(w1, b1, w2, b2)
            out = fab.fused_attention_block_fwd(xx, *params, mask, heads)
            ref = fab.fused_attention_block_reference(xx, w1, b1, w2, b2, mask)
            torch.cuda.synchronize()
            check(f"fused fwd {name}", key, [out], [ref], rel, row)
        row["ms"] = cuda_ms(lambda: fab.fused_attention_block_fwd(xx, *params, mask, heads))
        row["plain_ms"] = cuda_ms(lambda: fab.fused_attention_block_reference(
            xx, w1, b1, w2, b2, mask))
        row["library_ms"] = cuda_ms(lambda: library_chain(xx, *params, ~mask[:, None, None, :],
                                                          heads))
        row["bound_ms"], row["bound_by"] = fused_bound(b, t, d, 2, backward=False, a=a)
        row["tflops"] = fused_ops(b, t, d, backward=False, a=a) / row["ms"] / 1e9
        print(f"[kernels] fused_attention_block_fwd {name} (B={b}, T={t}, D={d}, H={heads}, "
              f"A={a}): "
              f"err f32 {row['max_abs_err_f32']:.3g} bf16 {row['max_abs_err_bf16']:.3g} (scaled "
              f"{row['scaled_err_f32']:.3g} / {row['scaled_err_bf16']:.3g}); "
              f"bf16 kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"linear+sdpa+linear {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); {row['tflops']:.1f} TFLOP/s", flush=True)
        fwd_rows.append(row)

    bwd_rows = []
    for i, (name, b, t, d, heads, *tp) in enumerate(FUSED_BWD_SHAPES + FUSED_TP_SHAPES):
        hd = tp[0] if tp else d // heads
        a = heads * hd
        x, weights, mask, grad = fused_inputs(b, t, d, heads, seed=400 + i, hd=hd)
        row = {"shape": name, "B": b, "T": t, "D": d, "H": heads, "hd": hd, "A": a,
               "core_bwd_route_bf16": flash_attention_bwd_route(t, hd, torch.bfloat16)}
        for dtype, rel, key in ((torch.float32, FUSED_F32_REL, "f32"),
                                (torch.bfloat16, FUSED_BF16_REL, "bf16")):
            xx, gg = x.to(dtype), grad.to(dtype)
            w1, b1, w2, b2 = (w.to(dtype) for w in weights)
            w_in, b_in, w_out, _ = torch_layout(w1, b1, w2, b2)
            grads = fab.fused_attention_block_bwd(xx, w_in, b_in, w_out, mask, gg, heads)
            again = fab.fused_attention_block_bwd(xx, w_in, b_in, w_out, mask, gg, heads)
            dx, dwqkv, dbqkv, dwo, dbo = fab.fused_attention_block_bwd_reference(
                xx, w1, b1, w2, mask, gg)  # in the JAX layouts: to the module's
            refs = (dx, *fab.unpack_weights(dwqkv, dbqkv, dwo), dbo.reshape(-1))
            torch.cuda.synchronize()
            check(f"fused bwd {name}", key, grads, refs, rel, row)
            if not all(torch.equal(a, c) for a, c in zip(grads, again)):
                raise AssertionError(f"fused bwd {name} {key}: two calls differ")
            # the fully masked row keeps its dS: its dx is the plain version's
            row0_err, ok = scaled_err(grads[0][0], refs[0][0], rel)
            if not ok:
                raise AssertionError(f"fused bwd {name} {key}: fully masked row dx ({row0_err})")
            row[f"masked_row_dx_err_{key}"] = row0_err
        row["deterministic"] = True
        row["ms"] = cuda_ms(lambda: fab.fused_attention_block_bwd(xx, w_in, b_in, w_out, mask, gg,
                                                                  heads))
        row["plain_ms"] = cuda_ms(lambda: fab.fused_attention_block_bwd_reference(
            xx, w1, b1, w2, mask, gg))
        # the library chain's backward: autograd through it less its forward,
        # timed in the same turn (derived, not one call)
        leaves = [a.detach().requires_grad_(True)
                  for a in (xx, *torch_layout(w1, b1, w2, b2))]
        keep = ~mask[:, None, None, :]
        fwd_ms = cuda_ms(lambda: library_chain(*leaves, keep, heads))
        both_ms = cuda_ms(lambda: torch.autograd.grad(library_chain(*leaves, keep, heads),
                                                      leaves, gg))
        row["library_ms"] = both_ms - fwd_ms
        row["library_fwd_bwd_ms"], row["library_fwd_ms"] = both_ms, fwd_ms
        row["bound_ms"], row["bound_by"] = fused_bound(b, t, d, 2, backward=True, a=a)
        row["tflops"] = fused_ops(b, t, d, backward=True, a=a) / row["ms"] / 1e9
        print(f"[kernels] fused_attention_block_bwd {name} (B={b}, T={t}, D={d}, H={heads}, "
              f"A={a}): "
              f"err f32 {row['max_abs_err_f32']:.3g} bf16 {row['max_abs_err_bf16']:.3g} (scaled "
              f"{row['scaled_err_f32']:.3g} / {row['scaled_err_bf16']:.3g}, masked row dx "
              f"{row['masked_row_dx_err_bf16']:.3g}), bitwise repeatable; bf16 "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, chain bwd (derived) "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
              f"{row['tflops']:.1f} TFLOP/s", flush=True)
        bwd_rows.append(row)
    return fwd_rows, bwd_rows


# (name, weight_grad, M, N, K) of the fused block's bf16 product alone: the
# QKV product of the full decoder batch (1024 × 128 tokens, D = 384), its
# weight gradient xᵀ·dqkv over those tokens, and serving's windowed QKV
# product (40 × 200 tokens, D = 768)
PRODUCT_SHAPES = [
    ("decoder_qkv", 0, 131072, 1152, 384),
    ("decoder_dwqkv", 1, 384, 1152, 131072),
    ("serve_qkv", 0, 8000, 2304, 768),
]
PRODUCT_BF16_REL = 1e-2  # bf16 output: one rounding of an f32 sum
PRODUCT_F32_REL = 1e-4   # f32 output: the same sums over 131k rows in another order


def sass_wgmma_counts(build) -> dict[str, dict[str, int]]:
    """HGMMA instructions (wgmma) in each built library's machine code, by
    kernel function (its mangled name, as ``cuobjdump -sass`` heads it)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    counts = {}
    for name in sorted(p.stem for p in build.CSRC_DIR.glob("*.cu")):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        functions, current = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                current = line.split("Function :", 1)[1].strip()
                functions.setdefault(current, 0)
            elif "HGMMA" in line and current is not None:
                functions[current] += 1
        counts[name] = functions
    return counts


def phase_products() -> list[dict]:
    """The fused block's bf16 product alone (hopper_gemm.cu's entry point,
    which no module of the main path calls) against torch.matmul, its plain
    version and its yardstick: checked against an f32 product of the same
    bf16 inputs (TF32 off), then both timed in turns (kernel, matmul,
    matmul, kernel)."""
    import ctypes

    from wavjepa_tpu_torch.ops import _build
    from wavjepa_tpu_torch.ops import fused_attention_block as fab

    fn = _build.load("hopper_gemm").wavjepa_hopper_gemm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
    fn.restype = i
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for n, (name, wgrad, m, nn, k) in enumerate(PRODUCT_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(500 + n)
        # weight_grad: a (K, M), b (K, N), c = aᵀ·b in f32 from split-K
        # partials; else a (M, K), b (N, K), c = a·bᵀ in bf16
        a = torch.randn(*((k, m) if wgrad else (m, k)), generator=g, device="cuda").bfloat16()
        b = torch.randn(*((k, nn) if wgrad else (nn, k)), generator=g, device="cuda").bfloat16()
        splits = fab.weight_grad_splits(k, -(-m // 128) * -(-nn // 128), sms) if wgrad else 1
        c = torch.empty(m, nn, device="cuda", dtype=torch.float32 if wgrad else torch.bfloat16)
        part = torch.empty(splits * m * nn, device="cuda") if wgrad else None
        stream = torch.cuda.current_stream().cuda_stream

        def kernel():
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                     None if part is None else part.data_ptr(), m, nn, k, wgrad, splits, stream)
            if err != 0:
                raise RuntimeError(f"hopper_gemm {name}: cudaError_t {err}")

        plain = (lambda: torch.matmul(a.T, b)) if wgrad else (lambda: torch.matmul(a, b.T))
        kernel()
        ref = torch.matmul(a.float().T, b.float()) if wgrad else torch.matmul(a.float(), b.float().T)
        torch.cuda.synchronize()
        err, ok = scaled_err(c, ref, PRODUCT_F32_REL if wgrad else PRODUCT_BF16_REL)
        if not ok or not torch.isfinite(c).all():
            raise AssertionError(f"product {name}: max |kernel - f32 product| {err}")
        del ref
        times = {"kernel": [], "matmul": []}
        for key, f in (("kernel", kernel), ("matmul", plain), ("matmul", plain), ("kernel", kernel)):
            times[key].append(cuda_ms(f))
        ms, lib_ms = min(times["kernel"]), min(times["matmul"])
        flop = 2 * m * nn * k
        row = {"shape": name, "M": m, "N": nn, "K": k, "splits": splits, "max_abs_err": err,
               "ms": ms, "matmul_ms": lib_ms, "tflops": flop / ms / 1e9,
               "matmul_tflops": flop / lib_ms / 1e9, "ms_turns": times}
        row["share_of_matmul"] = row["tflops"] / row["matmul_tflops"]
        print(f"[kernels] hopper_gemm {name} ({m} × {k})·({k} × {nn}){' over split-K ' + str(splits) if wgrad else ''}: "
              f"err {err:.3g}; kernel {ms:.4f} ms = {row['tflops']:.1f} TFLOP/s, torch.matmul "
              f"{lib_ms:.4f} ms = {row['matmul_tflops']:.1f} TFLOP/s "
              f"({row['share_of_matmul']:.2f} of it), in turns", flush=True)
        rows.append(row)
    return rows


def make_clips(seconds: list[float], seed: int, sr: int = 16000) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(round(s * sr))).astype(np.float32) * 0.1
            for s in seconds]


# the fused residual-add + LayerNorm32 at the main paths' row counts (rows, D,
# eps): 256 crops of the one-pass step, a Nat microbatch, serving's windows
LAYER_NORM_SHAPES = [
    ("student encoder (256·88, 768)", 256 * 88, 768, 1e-6),
    ("predictor (1024·128, 384)", 1024 * 128, 384, 1e-6),
    ("teacher (256·200, 768)", 256 * 200, 768, 1e-6),
    ("feature_norms (256·200, 512)", 256 * 200, 512, 1e-5),
    ("Nat encoder (16·176, 768)", 16 * 176, 768, 1e-6),
    ("Nat predictor (64·256, 384)", 64 * 256, 384, 1e-6),
    ("Nat teacher (16·400, 768)", 16 * 400, 768, 1e-6),
    ("serve (40·200, 768)", 40 * 200, 768, 1e-6),
]
# layer_norm32's launches (forward, backward) a microbatch of the AudioSet
# configuration: feature_norms, the student encoder's 2·12 + 1, the
# predictor's 2·12 + 1 and the teacher's 2·12 (its layer outputs), forward;
# the first three backward; at accum 1 the predictor's 24 replayed too
LAYER_NORM_PER_MICROBATCH = {"fwd": 75, "bwd": 51}
LAYER_NORM_REPLAYED = {"fwd": 99, "bwd": 51}


def layer_norm_bound(rows: int, d: int, elem: int, backward: bool) -> tuple[float, str]:
    """Least time for a training call with a residual: forward x and the
    residual read, y and s written; backward dy and s read, ds written;
    each row's two f32 statistics, and the f32 parameters (and their
    gradients) once. Memory bounds it (under one operation a byte)."""
    per_row = 3 * d * elem + 8
    params = 12 * d if backward else 8 * d
    bytes_moved = rows * (per_row + (0 if backward else d * elem)) + params
    return bytes_moved / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_layer_norm() -> list[dict]:
    """``ops/layer_norm.py``'s kernels against their plain versions at the
    main paths' shapes, in bf16 and f32, with and without a residual:
    forward (y, and s bit for bit), backward (ds, dweight, dbias), and the
    backward twice with equal bits; then the bf16 training call timed beside
    its bound, the plain versions and ``F.layer_norm`` (the yardstick: the
    port never calls it), and the forward alone without saving (serving and
    the teacher)."""
    import torch.nn.functional as F

    from wavjepa_tpu_torch.ops import layer_norm as L

    rows_out = []
    for n, (name, rows, d, eps) in enumerate(LAYER_NORM_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(700 + n)
        x = 3.0 * torch.randn(rows, d, generator=g, device="cuda") + 0.5
        r = torch.randn(rows, d, generator=g, device="cuda")
        w = 1.0 + 0.3 * torch.randn(d, generator=g, device="cuda")
        b = 0.2 * torch.randn(d, generator=g, device="cuda")
        dy = torch.randn(rows, d, generator=g, device="cuda")
        row = {"shape": name, "rows": rows, "D": d, "eps": eps}
        for dtype, rel, key in ((torch.float32, F32_REL, "f32"), (torch.bfloat16, BF16_REL, "bf16")):
            errs = []
            for res in (None, r.to(dtype)):
                xx, gy = x.to(dtype), dy.to(dtype)
                y, s, mean, rstd = L.layer_norm32_fwd(xx, w, b, eps, dtype, res, save=True)
                y_ref, s_ref, _, _ = L._reference_fwd(xx, w, b, eps, dtype, res)
                ds, dw, db = L.layer_norm32_bwd(gy, s, mean, rstd, w)
                again = L.layer_norm32_bwd(gy, s, mean, rstd, w)
                ds_ref, dw_ref, db_ref = L.layer_norm32_bwd_reference(gy, s, mean, rstd, w)
                torch.cuda.synchronize()
                if not torch.equal(s, s_ref):
                    raise AssertionError(f"layer_norm {name} {key}: s differs from the plain add")
                if not all(torch.equal(u, v) for u, v in zip((ds, dw, db), again)):
                    raise AssertionError(f"layer_norm {name} {key}: backward not deterministic")
                for what, out, ref in (("y", y, y_ref), ("ds", ds, ds_ref), ("dw", dw, dw_ref),
                                       ("db", db, db_ref)):
                    err, ok = scaled_err(out, ref, rel)
                    if not ok or not torch.isfinite(out).all():
                        raise AssertionError(f"layer_norm {name} {key} residual "
                                             f"{res is not None}: {what} max |kernel - plain| {err}")
                    errs.append(err)
            row[f"max_abs_err_{key}"] = max(errs)
        xx, rr, gy = x.bfloat16(), r.bfloat16(), dy.bfloat16()
        bf = torch.bfloat16
        _, s, mean, rstd = L.layer_norm32_fwd(xx, w, b, eps, bf, rr, save=True)
        _, s_p, mean_p, rstd_p = L._reference_fwd(xx, w, b, eps, bf, rr)
        row["ms"] = cuda_ms(lambda: L.layer_norm32_fwd(xx, w, b, eps, bf, rr, save=True))
        row["no_save_ms"] = cuda_ms(lambda: L.layer_norm32_fwd(xx, w, b, eps, bf, rr))
        row["bwd_ms"] = cuda_ms(lambda: L.layer_norm32_bwd(gy, s, mean, rstd, w))
        row["plain_ms"] = cuda_ms(lambda: L._reference_fwd(xx, w, b, eps, bf, rr))
        row["plain_bwd_ms"] = cuda_ms(
            lambda: L.layer_norm32_bwd_reference(gy, s_p, mean_p, rstd_p, w))
        wb, bb = w.bfloat16(), b.bfloat16()
        row["library_ms"] = cuda_ms(lambda: F.layer_norm(xx + rr, (d,), wb, bb, eps))
        xl = (xx + rr).requires_grad_(True)
        wl, bl = wb.clone().requires_grad_(True), bb.clone().requires_grad_(True)

        def library_step():
            out = F.layer_norm(xl, (d,), wl, bl, eps)
            torch.autograd.grad(out, (xl, wl, bl), gy)

        fwd_bwd = cuda_ms(library_step)
        row["library_bwd_ms"] = fwd_bwd - cuda_ms(lambda: F.layer_norm(xl, (d,), wl, bl, eps))
        row["bound_ms"], row["bound_by"] = layer_norm_bound(rows, d, 2, backward=False)
        row["bwd_bound_ms"], _ = layer_norm_bound(rows, d, 2, backward=True)
        print(f"[kernels] layer_norm {name}: err f32 {row['max_abs_err_f32']:.3g} bf16 "
              f"{row['max_abs_err_bf16']:.3g}; bf16 with a residual: forward {row['ms']:.4f} ms "
              f"({row['no_save_ms']:.4f} without saving), bound {row['bound_ms']:.4f}, plain "
              f"{row['plain_ms']:.4f}, F.layer_norm {row['library_ms']:.4f}; backward "
              f"{row['bwd_ms']:.4f} ms, bound {row['bwd_bound_ms']:.4f}, plain "
              f"{row['plain_bwd_ms']:.4f}, F.layer_norm {row['library_bwd_ms']:.4f}", flush=True)
        rows_out.append(row)
        del x, r, dy, xx, rr, gy, s, s_p, xl
    return rows_out


# WavLM's gated relative-position bias in the flash forward (``relbias_flash``,
# kernel row 6), (name, B, H, T) at d 64: a request of 16 utterances padded to
# LibriSpeech's 35-s maximum (1,749 frames) and to 880, then the tile edges
RELBIAS_SHAPES = [
    ("WavLM request (16, 16, 1749, 64)", 16, 16, 1749),
    ("WavLM request (16, 16, 880, 64)", 16, 16, 880),
    *((f"edge T = {t} (4, 16, {t}, 64)", 4, 16, t) for t in (1, 63, 65, 129)),
]
RELBIAS_TIMED = 2  # the request shapes, timed
# against the plain f32 formula: the flash forward's tolerances, and one ulp
# of |o| above them (bf16 2^-7; f32 sums over 1,749 keys in another order),
# since the bias sharpens P so that |o| reaches 2-4
RELBIAS_BF16_RTOL, RELBIAS_F32_RTOL = 2.0**-7, 1e-5
# phase 3c (WavLM): one request of 16 utterances evenly over LibriSpeech's
# 12.30 ± 6 s with its 35-s maximum among them (1,749 frames), as the longest
# requests of the benchmark's `wavlm-large-embed`; the request timed this often
WAVLM_SECONDS = [*(12.3 + 6.0 * ((2 * i + 1) / 16 - 1) for i in range(15)), 35.0]
WAVLM_TIMED = 10


def relbias_bound(b: int, h: int, t: int, d: int) -> tuple[float, str]:
    """Least time for the biased forward in bf16: q, k, v read and o written
    once, the key mask, the (H, 256·⌈T/128⌉) f32 table and the (B, H, T)
    f32 gate read once, against 4·B·H·T²·d operations (QKᵀ and PV)."""
    nb = -(-t // 128)
    bytes_moved = 4 * b * h * t * d * 2 + b * t + h * 256 * nb * 4 + b * h * t * 4
    ops = 4 * b * h * t * t * d
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def relbias_inputs(b, h, t, d, seed):
    """q, k, v (B, H, T, d) f32 on the card; a key mask with each row's tail
    past its length and a tenth of the keys masked (row 0 wholly where B >
    1); a table in the kernel's layout and a (B, H, T) gate in WavLM's range
    (1, 3)."""
    from wavjepa_tpu_torch.ops.flash_attention import relbias_offsets

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda") for _ in range(3))
    lengths = torch.randint(max(1, t // 3), t + 1, (b,), generator=g, device="cuda")
    lengths[-1] = t
    mask = torch.arange(t, device="cuda")[None, :] >= lengths[:, None]
    mask |= torch.rand(b, t, generator=g, device="cuda") < 0.1
    if b > 1:
        mask[0] = True
    table = torch.randn(h, relbias_offsets(t).numel(), generator=g, device="cuda")
    gate = 1.0 + 2.0 * torch.rand(b, h, t, generator=g, device="cuda")
    return q, k, v, mask, table, gate


def phase_relbias() -> list[dict]:
    """The ``relbias_flash`` kernels through ``relbias_attention`` against
    their plain version (``flash_attention_reference`` with
    ``relbias_dense``'s bias) at ``RELBIAS_SHAPES``, bf16 and f32, one launch
    a call; with a zero table and a unit gate, the bf16 kernel against the
    unbiased one within an output ulp; then at the request shapes the bf16
    kernel timed beside its bound, the plain version and the library route
    it replaces (the bias materialised in bf16 with the key mask folded in,
    then SDPA)."""
    import torch.nn.functional as F

    from wavjepa_tpu_torch.ops import flash_attention as FA

    rows = []
    for i, (name, b, h, t) in enumerate(RELBIAS_SHAPES):
        q, k, v, mask, table, gate = relbias_inputs(b, h, t, HEAD_DIM, seed=800 + i)
        row = {"shape": name, "B": b, "H": h, "T": t, "d": HEAD_DIM}
        for dtype, atol, rtol, key in ((torch.float32, F32_ATOL, RELBIAS_F32_RTOL, "f32"),
                                       (torch.bfloat16, BF16_ATOL, RELBIAS_BF16_RTOL, "bf16")):
            qq, kk, vv = (x.to(dtype) for x in (q, k, v))
            before = FA.relbias_flash_attention_fwd.launches
            out = FA.relbias_attention(qq, kk, vv, mask, table, gate)
            ref = FA.flash_attention_reference(qq, kk, vv, mask, FA.relbias_dense(table, gate))
            torch.cuda.synchronize()
            if FA.relbias_flash_attention_fwd.launches != before + 1:
                raise AssertionError(f"relbias {name} {key}: the kernel did not run once")
            diff = (out.float() - ref.float()).abs()
            excess = (diff - (atol + rtol * ref.float().abs())).max().item()
            row[f"max_abs_err_{key}"] = diff.max().item()
            if not torch.isfinite(out).all() or excess > 0:
                raise AssertionError(f"relbias {name} {key}: max |kernel - plain| "
                                     f"{row[f'max_abs_err_{key}']} (over the tolerance by {excess})")
            del out, ref, diff
        qq, kk, vv = (x.to(torch.bfloat16) for x in (q, k, v))
        zero = FA.relbias_attention(qq, kk, vv, mask, torch.zeros_like(table),
                                    torch.ones_like(gate)).float()
        unbiased = FA.flash_attention_fwd(qq, kk, vv, mask)[0].float()
        ulp = torch.finfo(torch.bfloat16).eps * unbiased.abs().clamp_min(2**-126)
        row["zero_bias_vs_unbiased"] = (zero - unbiased).abs().max().item()
        if not ((zero - unbiased).abs() <= ulp).all():
            raise AssertionError(f"relbias {name}: zero bias differs from the unbiased kernel "
                                 f"by {row['zero_bias_vs_unbiased']}, over an ulp")
        del zero, unbiased
        if i < RELBIAS_TIMED:
            def library():
                bias = FA.relbias_dense(table, gate).masked_fill(mask[:, None, None, :], -1e30)
                return F.scaled_dot_product_attention(qq, kk, vv, bias.bfloat16())

            row["ms"] = cuda_ms(lambda: FA.relbias_attention(qq, kk, vv, mask, table, gate))
            row["plain_ms"] = cuda_ms(lambda: FA.flash_attention_reference(
                qq, kk, vv, mask, FA.relbias_dense(table, gate)), iters=5)
            row["library_ms"] = cuda_ms(library, iters=5)
            row["bound_ms"], row["bound_by"] = relbias_bound(b, h, t, HEAD_DIM)
            print(f"[kernels] relbias_flash_attention_fwd {name}: err f32 "
                  f"{row['max_abs_err_f32']:.3g} bf16 {row['max_abs_err_bf16']:.3g}, zero bias "
                  f"vs unbiased {row['zero_bias_vs_unbiased']:.3g}; bf16 kernel {row['ms']:.4f} "
                  f"ms, plain {row['plain_ms']:.4f} ms, bias materialised + sdpa "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
        else:
            print(f"[kernels] relbias_flash_attention_fwd {name}: err f32 "
                  f"{row['max_abs_err_f32']:.3g} bf16 {row['max_abs_err_bf16']:.3g}, zero bias "
                  f"vs unbiased {row['zero_bias_vs_unbiased']:.3g}", flush=True)
        rows.append(row)
        del q, k, v, qq, kk, vv, mask, table, gate
        torch.cuda.empty_cache()
    return rows


def phase_wavlm_serve() -> dict:
    """WavLM Large (seeded weights, bf16 with f32 norms) served through
    ``api/hear_wavlm`` and ``api/runtime.RuntimeWavLM``, whole utterances
    padded to the longest: one request of ``WAVLM_SECONDS``, the launch
    counters zeroed just before it. The biased kernel runs once a layer, the
    norm kernel 2·layers + 2 times (the projection, layer 0's input, two
    joins a layer but the last layer's second, the final norm), and neither
    the unbiased flash forward nor a backward. Scene embeddings (16, 1,024)
    and timestamp embeddings finite; each utterance's averaged frames the
    frontend's count of its samples; the request then timed."""
    from wavjepa_tpu_torch.api import hear_wavlm
    from wavjepa_tpu_torch.ops import flash_attention as FA
    from wavjepa_tpu_torch.ops import layer_norm as L

    model = hear_wavlm.load_model("", device="cuda", seed=0)
    cfg = model.config
    clips = make_clips(WAVLM_SECONDS, 21)
    frames = [cfg.frames(len(c)) for c in clips]
    if model.valid_frames(clips) != frames:
        raise AssertionError(f"wavlm: valid frames {model.valid_frames(clips)}, "
                             f"expected {frames}")
    hear_wavlm.get_scene_embeddings(clips, model).cpu()  # warm: cuDNN picks its convolution
    counters = {"relbias_flash_attention_fwd": FA.relbias_flash_attention_fwd,
                "layer_norm32_fwd": L.layer_norm32_fwd,
                "flash_attention_fwd": FA.flash_attention_fwd,
                "flash_attention_bwd": FA.flash_attention_bwd,
                "layer_norm32_bwd": L.layer_norm32_bwd}
    for c in counters.values():
        c.launches = 0
    scene = hear_wavlm.get_scene_embeddings(clips, model).cpu()
    launches = {k: c.launches for k, c in counters.items()}
    layers = cfg.num_hidden_layers
    expected = {"relbias_flash_attention_fwd": layers, "layer_norm32_fwd": 2 * layers + 2,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0, "layer_norm32_bwd": 0}
    if launches != expected:
        raise AssertionError(f"wavlm request launched {launches}, expected {expected}")
    if scene.shape != (len(clips), cfg.hidden_size) or not torch.isfinite(scene).all():
        raise AssertionError(f"wavlm scene embeddings {tuple(scene.shape)}, finite "
                             f"{bool(torch.isfinite(scene).all())}")
    emb, ts = hear_wavlm.get_timestamp_embeddings(clips, model)
    if emb.shape != (len(clips), max(frames), cfg.hidden_size) or ts.shape != emb.shape[:2] \
            or not torch.isfinite(emb).all():
        raise AssertionError(f"wavlm timestamp embeddings {tuple(emb.shape)}, timestamps "
                             f"{tuple(ts.shape)}")
    del emb, ts
    times = []
    for _ in range(WAVLM_TIMED):
        t0 = time.perf_counter()
        hear_wavlm.get_scene_embeddings(clips, model).cpu()
        times.append(1000.0 * (time.perf_counter() - t0))
    record = {"seconds": WAVLM_SECONDS, "frames": max(frames), "launches": launches,
              "request_p50_ms": statistics.median(times), "request_ms": times,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(f"[serve wavlm] 16 utterances (6.68-17.93 s and 35 s, T = {max(frames)}): launches "
          f"{launches}; request p50 {record['request_p50_ms']:.1f} ms over {WAVLM_TIMED}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return record


def phase_serve(counted, idle, load_model, chunk_padding, config=None,
                reference=None) -> tuple[dict, object, dict]:
    """The HEAR requests at base width with the weights of seed 0, on the
    default path or, given ``config``, on its path: ``counted`` must launch
    once per encoder layer per request and ``idle`` never. With
    ``reference`` (phase 3's embeddings) each request's embeddings are held
    to them. Returns the record, the requests (name, runtime, kind, clips)
    and the embeddings."""
    if config is None:
        windowed = load_model("", model_size="base", seed=0)
        whole = load_model("", model_size="base", process_seconds=10.0, seed=0)
    else:
        windowed = load_model("", config=config, seed=0)
        whole = load_model("", config=dataclasses.replace(config, process_seconds=10.0), seed=0)
    layers = windowed.config.encoder_layers
    tag = "serve" if config is None else f"serve {config.attn_impl}"
    requests = [
        ("scene_8x10s", windowed, "scene", make_clips([10.0] * 8, 1)),
        ("timestamps_ragged", windowed, "timestamps", make_clips([1.0, 2.01, 4.3, 30.0], 2)),
        # exactly one window of samples: a whole padding window follows it
        ("timestamps_exact_window", windowed, "timestamps",
         make_clips([windowed.unit_frames / 16000], 3)),
        ("whole_clip_4x10s", whole, "timestamps", make_clips([10.0] * 4, 4)),
    ]

    from wavjepa_tpu_torch.ops.layer_norm import layer_norm32_bwd, layer_norm32_fwd

    record, outputs = {}, {}
    counted.launches = idle.launches = 0  # the main path's run starts here
    for name, rt, kind, clips in requests:
        before = counted.launches
        norms_before = (layer_norm32_fwd.launches, layer_norm32_bwd.launches)
        emb, ts = serve_request(rt, kind, clips)
        torch.cuda.synchronize()
        if counted.launches - before != layers or idle.launches:
            raise AssertionError(f"{name}: {counted.launches - before} kernel launches, "
                                 f"expected {layers} (one per encoder layer), and "
                                 f"{idle.launches} of the other attention kernel")
        # feature_norms, two a layer and the final norm; no backward
        norms = (layer_norm32_fwd.launches - norms_before[0],
                 layer_norm32_bwd.launches - norms_before[1])
        if norms != (2 * layers + 2, 0):
            raise AssertionError(f"{name}: layer_norm32 launches (forward, backward) {norms}, "
                                 f"expected ({2 * layers + 2}, 0)")
        outputs[name] = emb
        n = max(len(c) for c in clips)
        _, n_chunks, cut_off, _ = chunk_padding(n, rt.unit_frames, rt.sample_rate,
                                                rt.output_steps)
        width = rt.embedding_size
        if kind == "scene":
            expect = (len(clips), width)
        else:
            expect = (len(clips), cut_off, width)
            if tuple(ts.shape) != expect[:2]:
                raise AssertionError(f"{name}: timestamps {tuple(ts.shape)} != {expect[:2]}")
            step = n / rt.sample_rate / cut_off * 1000.0
            if ts[0, 0].item() != 0.0 or abs(ts[0, 1].item() - step) > 1e-9:
                raise AssertionError(f"{name}: timestamps not a {step}-ms grid")
        if tuple(emb.shape) != expect or emb.dtype != torch.float32:
            raise AssertionError(f"{name}: embeddings {tuple(emb.shape)} != {expect}")
        if not torch.isfinite(emb).all():
            raise AssertionError(f"{name}: non-finite embeddings")
        if n % rt.unit_frames == 0 and n_chunks != n // rt.unit_frames + 1:
            raise AssertionError(f"{name}: exact multiple of the window lacks its pad window")
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            serve_request(rt, kind, clips)
            torch.cuda.synchronize()
            if i >= 2:  # two warm-up requests
                times.append((time.perf_counter() - t0) * 1e3)
        record[name] = {
            "shape": list(emb.shape), "windows": len(clips) * n_chunks,
            "tokens_per_window": rt.output_steps,
            "p50_ms": statistics.median(times), "n": len(times),
        }
        vs = ""
        if reference is not None:  # bf16 on both paths, the same weights
            rel = (torch.linalg.norm(emb - reference[name]) / torch.linalg.norm(reference[name])).item()
            if not rel <= BF16_REL_FRO:
                raise AssertionError(f"{name}: relative Frobenius {rel} to the default path")
            record[name]["rel_fro_vs_default"] = rel
            vs = f", relative Frobenius to phase 3 {rel:.4g} (limit {BF16_REL_FRO})"
        print(f"[{tag}] {name}: out {tuple(emb.shape)}, {len(clips) * n_chunks} windows of "
              f"{rt.output_steps} tokens, p50 {record[name]['p50_ms']:.3f} ms "
              f"over {len(times)} requests{vs}", flush=True)
    launches, idle_launches = counted.launches, idle.launches  # read just after the main path
    expected = layers * 13 * len(requests)
    if launches != expected or idle_launches:
        raise AssertionError(f"main path launched the kernel {launches} times, not {expected}, "
                             f"and the other attention kernel {idle_launches} times")
    record["launches"] = launches
    record["launches_per_encoder_forward"] = layers
    return record, requests, outputs


def serve_request(rt, kind, clips):
    if kind == "scene":
        return rt.get_scene_embeddings(clips), None
    return rt.get_timestamp_embeddings(clips)


def phase_serve_turns(default_requests, fused_requests) -> dict:
    """Request p50 of both attention paths timed in turns on the same clips
    (default, fused, then fused, default, ...), so that the host's drift
    falls on both; these launches compare the paths and are not counted."""
    record = {}
    for (name, rt_d, kind, clips), (_, rt_f, _, _) in zip(default_requests, fused_requests):
        times = {"default": [], "fused_block": []}
        for i in range(14):
            turn = [("default", rt_d), ("fused_block", rt_f)]
            for key, rt in turn if i % 2 == 0 else turn[::-1]:
                t0 = time.perf_counter()
                serve_request(rt, kind, clips)
                torch.cuda.synchronize()
                if i >= 2:  # two warm-up turns
                    times[key].append((time.perf_counter() - t0) * 1e3)
        record[name] = {f"{k}_p50_ms": statistics.median(v) for k, v in times.items()}
        record[name]["n"] = len(times["default"])
        print(f"[serve turns] {name}: p50 default {record[name]['default_p50_ms']:.3f} ms, "
              f"fused_block {record[name]['fused_block_p50_ms']:.3f} ms over "
              f"{record[name]['n']} requests each, in turns", flush=True)
    return record


def phase_parity(load_model, JEPAConfig, bf16_runtime) -> dict:
    cfg = JEPAConfig(dtype=torch.float32)
    clips = make_clips([2.01, 1.0], 5)
    card = load_model("", config=cfg, device="cuda", seed=0)
    cpu = load_model("", config=cfg, device="cpu", seed=0)
    e_card = card.get_timestamp_embeddings(clips)[0].cpu()
    e_cpu = cpu.get_timestamp_embeddings(clips)[0]
    err = (e_card - e_cpu).abs().max().item()
    if not torch.allclose(e_card, e_cpu, atol=CARD_CPU_ATOL, rtol=CARD_CPU_ATOL):
        raise AssertionError(f"f32 card vs CPU: max abs err {err}")
    e_bf16 = bf16_runtime.get_timestamp_embeddings(clips)[0].cpu()
    rel = (torch.linalg.norm(e_bf16 - e_card) / torch.linalg.norm(e_card)).item()
    if not rel <= BF16_REL_FRO:
        raise AssertionError(f"bf16 vs f32 on the card: relative Frobenius {rel} > {BF16_REL_FRO}")
    print(f"[parity] f32 card vs CPU max abs err {err:.3g} (atol {CARD_CPU_ATOL}); "
          f"bf16 vs f32 card relative Frobenius {rel:.4g} (limit {BF16_REL_FRO})", flush=True)
    return {"f32_card_vs_cpu_max_abs_err": err, "bf16_vs_f32_rel_fro": rel,
            "shape": list(e_card.shape)}


def encoder_weights(model) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in model.encoder.state_dict().items()}


def primed_shard_batches(cfg, build) -> tuple:
    """The run's shard pipeline (``build(cfg)``), primed to its steady state
    before the run: the shuffle buffer filled and the queue full, as it
    stays in a long run, where the workers produce faster than the card
    consumes and wait in put. Returns (the batches for the loop, wrapped so
    that the time each batch kept the prefetch waiting is recorded, as a
    ``ShardBatches`` over the same source, which the loop reads a scene
    bank from; the pipeline, whose ``stop()`` the caller owns; the waits in
    ms; the priming's record)."""
    from wavjepa_tpu_torch.data.pipeline import ShardBatches

    loader_waits, primed = [], {}
    t0 = time.perf_counter()
    batches = build(cfg)
    first = next(batches)
    source = getattr(batches.source, "audio", batches.source)  # the clean clips
    primed["buffer_s"] = time.perf_counter() - t0
    if isinstance(first, np.ndarray):  # a clip batch, as the loader hands it over
        primed["first"] = {"shape": list(first.shape), "dtype": str(first.dtype),
                           "peak": int(np.abs(first).max())}
    q0, t1 = source.queue.qsize(), time.perf_counter()
    while (source.queue.qsize() < source.queue_size - cfg.trainer.batch_size
           and time.perf_counter() - t0 < LOADER_PRIME_S):
        time.sleep(0.1)
    primed["queue_s"] = time.perf_counter() - t0
    primed["queue"] = source.queue.qsize()
    # clips the workers produced a second while the queue filled, nothing
    # taken from it: the loader's rate without the card
    primed["produced_clips_per_s"] = (primed["queue"] - q0) / max(time.perf_counter() - t1,
                                                                  1e-9)

    def timed_batches():
        yield first
        while True:
            t1 = time.perf_counter()
            batch = next(batches)
            loader_waits.append((time.perf_counter() - t1) * 1e3)
            yield batch

    return ShardBatches(batches.source, timed_batches()), batches, loader_waits, primed


def seeded_encoder(cfg) -> dict:
    """The student encoder's weights that a run of ``cfg`` starts from
    (read-only), made on the host once a model configuration and seed: the
    runs of one configuration on synthetic data and from shards share
    them."""
    from wavjepa_tpu_torch.models.jepa import jepa_config_to_dict

    return _seeded_encoder(json.dumps(jepa_config_to_dict(cfg.build_model_config()),
                                      sort_keys=True), cfg.trainer.seed)


@functools.cache
def _seeded_encoder(model_config: str, seed: int) -> dict:
    from wavjepa_tpu_torch.models.jepa import JEPA, jepa_config_from_dict

    init = JEPA(jepa_config_from_dict(json.loads(model_config)))
    init.init_parameters(torch.Generator().manual_seed(seed))
    return encoder_weights(init)


def checked_run(name: str, cfg, run_dir: str, steps: int, per_microbatch: dict,
                launches: dict, peak: int, start: dict, student: dict, teacher: dict,
                warmup: int) -> dict:
    """What every train run here is held to, and its record: exactly
    ``per_microbatch`` launches of each counted wrapper a microbatch;
    ``steps`` finite losses in the run's metrics; the teacher's encoder moved
    from ``start`` less than the student's (``student`` and ``teacher`` the
    weights after the run); the step and data-wait p50s after the first
    ``warmup`` steps, clips/s, crops/s, MFU (replays not counted) and peak
    memory."""
    from wavjepa_tpu_torch.utils import flops

    model_cfg, a = cfg.build_model_config(), cfg.resolved_accum_steps()
    expected = {k: n * a * steps for k, n in per_microbatch.items()}
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected {expected} "
                             f"({a} microbatches)")
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = [line["loss"] for line in lines]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    d_student = sum((v - start[k]).abs().sum().item() for k, v in student.items())
    d_teacher = sum((v - start[k]).abs().sum().item() for k, v in teacher.items())
    if not 0 < d_teacher < d_student:
        raise AssertionError(f"{name}: teacher moved {d_teacher}, student {d_student}")
    p50 = statistics.median(line["step_time_ms"] for line in lines[warmup:])
    b, crops = cfg.trainer.batch_size, cfg.trainer.batch_size * cfg.data.samples_per_audio
    step_flops = flops.jepa_step_flops(model_cfg, crops)
    return {
        "accum_steps": a, "steps": steps, "warmup": warmup, "batch": b, "crops": crops,
        "pack": [model_cfg.pack_encoder, model_cfg.pack_decoder],
        "losses": losses, "grad_norms": [line["grad_norm"] for line in lines],
        "step_ms": [line["step_time_ms"] for line in lines], "step_p50_ms": p50,
        "clips_per_s": b / (p50 / 1e3), "crops_per_s": crops / (p50 / 1e3),
        "step_tflop": step_flops / 1e12, "mfu": flops.mfu(step_flops, p50 / 1e3),
        "max_memory_allocated_bytes": peak, "launches": launches,
        "student_encoder_moved": d_student, "teacher_moved": d_teacher,
        "attn_impl": model_cfg.attn_impl, "attn_impl_decoder": model_cfg.attn_impl_decoder,
        "data_wait_ms": [line["data_wait_ms"] for line in lines],
        "data_wait_p50_ms": statistics.median(line["data_wait_ms"] for line in lines[warmup:]),
    }


def run_summary(rec: dict) -> str:
    """``checked_run``'s record in a line."""
    return (f"{rec['steps']} steps of {rec['batch']} clips × {rec['crops'] // rec['batch']} "
            f"crops, {rec['accum_steps']} microbatches, pack {rec['pack']}; losses "
            f"{', '.join(f'{x:.5f}' for x in rec['losses'])}; step p50 "
            f"{rec['step_p50_ms']:.1f} ms after {rec['warmup']} warm-up steps (each: "
            f"{', '.join(f'{x:.1f}' for x in rec['step_ms'])}), {rec['clips_per_s']:.2f} "
            f"clips/s, {rec['crops_per_s']:.1f} crops/s, MFU {rec['mfu']:.4f} of "
            f"{rec['step_tflop']:.2f} TFLOP (replays not counted), peak memory "
            f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB; data wait p50 "
            f"{rec['data_wait_p50_ms']:.2f} ms a step (each: "
            f"{', '.join(f'{x:.2f}' for x in rec['data_wait_ms'])}); launches "
            f"{rec['launches']}, layer_norm32 {rec.get('layer_norm_launches')}; teacher moved {rec['teacher_moved']:.4g} < student "
            f"{rec['student_encoder_moved']:.4g}")


def phase_train(counters: dict, runs: list, shards: str = "", keep: dict = None,
                warmup: int = TRAIN_WARMUP, recipe: str = None) -> dict:
    """train_jepa on the AudioSet configuration as resolved (or on the
    configuration file ``recipe``), once per run (name, overrides, steps,
    launches of each counted wrapper a microbatch, whether to serve from its
    checkpoint), on synthetic clips (or scenes) or, given a shard pattern,
    from the run's shard pipeline (``build_data_iterator``: clips, or Nat
    scene batches with their banks), wrapped so that the time each batch
    kept the loader waiting is recorded; the launch counts are set to 0 just
    before each run and read just after it; ``checked_run``'s checks.
    ``keep`` maps a run's name to a directory that its last checkpoint and
    model_config.json are moved to, for a later phase."""
    import shutil

    from wavjepa_tpu_torch.api.runtime import load_model
    from wavjepa_tpu_torch.ops import layer_norm
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config
    from wavjepa_tpu_torch.train.loop import build_data_iterator, train_jepa

    norm_counters = {"fwd": layer_norm.layer_norm32_fwd, "bwd": layer_norm.layer_norm32_bwd}
    record = {}
    for name, extra, steps, per_microbatch, serve in runs:
        save_dir = os.path.join("build", "chip_smoke_train", name)
        shutil.rmtree(save_dir, ignore_errors=True)
        # the warmup is cut to 2 steps so that these few steps take real
        # updates (at the configured 100k it is lr 4e-9 at step 1)
        source = ["data.synthetic=false", f"data.data_dirs={shards}"] if shards else [
            "data.synthetic=true"]
        cfg = apply_overrides(load_config(recipe), [
            *source, f"trainer.save_dir={save_dir}", "trainer.log_every=1",
            "optimizer.warmup_steps=2", *extra])
        model_cfg = cfg.build_model_config()
        start = seeded_encoder(cfg)
        batches, loader_waits, data_iter, primed = None, [], None, {}
        if shards:
            data_iter, batches, loader_waits, primed = primed_shard_batches(
                cfg, build_data_iterator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in (*counters.values(), *norm_counters.values()):  # the run starts here
            counter.launches = 0
        try:
            state = train_jepa(cfg, data_iter=data_iter, max_steps=steps, device="cuda")
            torch.cuda.synchronize()
        finally:
            if batches is not None:
                batches.stop()
        launches = {k: c.launches for k, c in counters.items()}  # read just after
        norm_launches = {k: c.launches for k, c in norm_counters.items()}
        if not all(norm_launches.values()):
            raise AssertionError(f"{name}: layer_norm32 launches {norm_launches}")
        run_dir = os.path.join(save_dir, cfg.run_identity())
        rec = checked_run(
            name, cfg, run_dir, steps, per_microbatch, launches,
            torch.cuda.max_memory_allocated(), start,
            {k: v.float().cpu() for k, v in state.model.encoder.state_dict().items()},
            {k: v.float().cpu() for k, v in state.teacher_encoder.state_dict().items()},
            warmup)
        rec["source"] = "shards" if shards else "synthetic"
        rec["layer_norm_launches"] = norm_launches
        if shards:
            rec["loader_wait_ms"], rec["primed"] = loader_waits, primed
        if serve:
            ckpt = os.path.join(run_dir, "ckpt", f"step_{steps:08d}.ckpt")
            if not (os.path.isfile(ckpt) and os.path.isfile(os.path.join(run_dir,
                                                                          "model_config.json"))):
                raise AssertionError(f"{name}: no checkpoint or model_config.json in {run_dir}")
            rt = load_model(ckpt)  # architecture from the sidecar
            emb = rt.get_scene_embeddings(make_clips([10.0, 4.0], 8))
            torch.cuda.synchronize()
            if tuple(emb.shape) != (2, rt.embedding_size) or not torch.isfinite(emb).all():
                raise AssertionError(f"{name}: served {tuple(emb.shape)} from the checkpoint")
            # served as the JAX package serves a sidecar: bf16, unpacked,
            # with the run's attention choices
            if (rt.config.dtype != torch.bfloat16 or rt.config.pack_encoder is not None
                    or rt.config.pack_decoder is not None
                    or rt.config.attn_impl_decoder != model_cfg.attn_impl_decoder):
                raise AssertionError(f"{name}: sidecar not read ({rt.config})")
            rec["served_from_checkpoint"] = list(emb.shape)
        if keep and name in keep:
            os.makedirs(keep[name], exist_ok=True)
            shutil.move(os.path.join(run_dir, "ckpt", f"step_{steps:08d}.ckpt"), keep[name])
            shutil.copy(os.path.join(run_dir, "model_config.json"), keep[name])
        shutil.rmtree(save_dir)  # ~1.7 GB of base-width checkpoint
        record[name] = rec
        print(f"[train] {name}: {run_summary(rec)}; {rec['source']}", flush=True)
    return record


def parity_case(overrides: tuple = (), recipe: str = None) -> tuple:
    """Phase 6's injected step: the run configuration (the defaults, or the
    file ``recipe``, at f32, 1 clip × 2 crops, one pass) with
    ``overrides``, its model configuration, and the crops and masks from
    seeded numpy."""
    from wavjepa_tpu_torch.ops.audio import instance_normalize
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(recipe), ["trainer.precision=f32", "trainer.batch_size=1",
                                                "data.samples_per_audio=2", *overrides])
    f32_cfg = cfg.build_model_config()
    masker, masker_cfg = cfg.masker.build()
    rng = np.random.default_rng(11)
    crops = instance_normalize(torch.from_numpy(rng.standard_normal(
        (2, f32_cfg.in_channels, f32_cfg.target_length)).astype(np.float32)))
    masks = masker(torch.Generator().manual_seed(11), batch_size=2,
                   n_times=f32_cfg.total_patches, in_channels=f32_cfg.in_channels,
                   cfg=masker_cfg)
    return cfg, f32_cfg, crops, masks


def injected_step(cfg, model_cfg, device, crops, masks) -> tuple:
    """One ``step_on`` of a seeded ``model_cfg`` model on ``device`` from
    ``parity_case``'s crops and masks at the peak learning rate: (loss,
    gradient norm, lr, weights, teacher), on the host."""
    from wavjepa_tpu_torch.models.jepa import JEPA
    from wavjepa_tpu_torch.train.state import TrainState
    from wavjepa_tpu_torch.train.step import OptimizerConfig, make_jepa_train_step, make_optimizer

    opt_cfg = OptimizerConfig(warmup_steps=1)  # step 1: lr = the peak, 4e-4
    model = JEPA(model_cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    state = TrainState.create(model, make_optimizer(opt_cfg, model))
    state.step = 1
    step = make_jepa_train_step(opt_cfg, nr_samples_per_audio=2,
                                masker_cfg=cfg.masker.build()[1], ema_cfg=cfg.ema)
    state, m = step.step_on(state, crops.to(device, model_cfg.dtype),
                            *(x.to(device) for x in masks))
    weights = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
    teacher = {k: v.detach().float().cpu() for k, v in state.teacher_encoder.state_dict().items()}
    return float(m["loss"]), float(m["grad_norm"]), m["lr"], weights, teacher


def phase_train_parity(overrides: tuple = (), tag: str = "train parity",
                       recipe: str = None) -> dict:
    """One injected step at base width: f32 on the card against the CPU,
    then bf16 on the card against that f32 step."""
    cfg, f32_cfg, crops, masks = parity_case(overrides, recipe)

    def one_step(model_cfg, device):
        return injected_step(cfg, model_cfg, device, crops, masks)

    card = one_step(f32_cfg, "cuda")
    cpu = one_step(f32_cfg, "cpu")
    lr = card[2]
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    gn_rel = abs(card[1] - cpu[1]) / abs(cpu[1])
    w_err = max((card[3][k] - cpu[3][k]).abs().max().item() for k in cpu[3])
    t_err = max((card[4][k] - cpu[4][k]).abs().max().item() for k in cpu[4])
    if not (loss_rel <= STEP_LOSS_REL and gn_rel <= STEP_GRAD_NORM_REL
            and w_err <= STEP_PARAM_ATOL_LR * lr and t_err <= STEP_TEACHER_ATOL):
        raise AssertionError(f"f32 step, card vs CPU: loss rel {loss_rel}, grad_norm rel "
                             f"{gn_rel}, weights {w_err} (lr {lr}), teacher {t_err}")
    bf16 = one_step(dataclasses.replace(f32_cfg, dtype=torch.bfloat16), "cuda")
    bf16_rel = abs(bf16[0] - card[0]) / abs(card[0])
    if not bf16_rel <= STEP_BF16_LOSS_REL:
        raise AssertionError(f"bf16 step vs f32 step on the card: loss rel {bf16_rel}")
    print(f"[{tag}] f32 step card vs CPU: loss {card[0]:.6f} vs {cpu[0]:.6f} (rel "
          f"{loss_rel:.3g}, limit {STEP_LOSS_REL}), grad_norm rel {gn_rel:.3g} (limit "
          f"{STEP_GRAD_NORM_REL}), weights max abs {w_err:.3g} (limit "
          f"{STEP_PARAM_ATOL_LR * lr:.3g} = {STEP_PARAM_ATOL_LR}·lr), teacher {t_err:.3g} "
          f"(limit {STEP_TEACHER_ATOL}); bf16 step loss {bf16[0]:.6f}, rel {bf16_rel:.3g} "
          f"(limit {STEP_BF16_LOSS_REL})", flush=True)
    return {"loss_card": card[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
            "grad_norm_card": card[1], "grad_norm_cpu": cpu[1], "grad_norm_rel": gn_rel,
            "weights_max_abs_err": w_err, "teacher_max_abs_err": t_err, "lr": lr,
            "bf16_loss": bf16[0], "bf16_loss_rel": bf16_rel}


def write_shards(root: str, seed: int = 0) -> str:
    """Phase 7's WebDataset shards, from seeded numpy: white noise under a
    slow envelope at about −20 dBFS, as PCM16 WAV, a json member beside
    each clip. Returns the brace pattern of the shards."""
    import io
    import tarfile

    from scipy.io import wavfile

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for s in range(DATA_SHARDS):
        with tarfile.open(os.path.join(root, f"shard-{s:04d}.tar"), "w") as tar:
            for i in range(DATA_CLIPS_PER_SHARD):
                sr, ch = (16000, 1) if i == DATA_CLIPS_PER_SHARD - 1 else (44100, 2)
                t = np.arange(10 * sr, dtype=np.float32) / sr
                env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.1, 2.0) * t)
                x = rng.standard_normal((t.size, ch), dtype=np.float32) * env[:, None] * 3000
                buf = io.BytesIO()
                wavfile.write(buf, sr, np.clip(x, -32768, 32767).astype(np.int16).squeeze())
                for ext, data in (("wav", buf.getvalue()), ("json", b'{"label": %d}' % i)):
                    info = tarfile.TarInfo(f"clip{s:04d}{i:02d}.{ext}")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    return os.path.join(root, f"shard-{{0000..{DATA_SHARDS - 1:04d}}}.tar")


def cli_in_process(module: str, argv: list) -> tuple[int, str, float]:
    """``python -m module *argv`` as its ``main`` in this process (a
    package's ``__main__``, or the module's own), standard output captured:
    the CLI's path without a new interpreter's start-up and its first touch
    of the card. Returns (exit code, output, seconds)."""
    import contextlib
    import importlib
    import importlib.util
    import io

    package = importlib.util.find_spec(module).submodule_search_locations is not None
    main = importlib.import_module(f"{module}.__main__" if package else module).main
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            rc = main(list(argv)) or 0
        except SystemExit as e:
            rc = e.code or 0
    return rc, out.getvalue(), time.perf_counter() - t0


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_data(counters: dict, synthetic_runs: dict) -> tuple[dict, dict]:
    """Phase 7: the host data path on this host, then training from shards.
    The native resampler against its plain version; one worker's cost a
    clip; the loader alone at 16 worker processes beside the clips a second
    the card consumes in phase 5; train_jepa from the shards at accum 16
    and accum 1 with phase 5's checks; and the CLI from the shards."""
    import shutil

    from wavjepa_tpu_torch.data import decode, pipeline, resample, shards
    from wavjepa_tpu_torch.train.config import Config, apply_overrides

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    pattern = write_shards(DATA_DIR)
    record = {"write_s": time.perf_counter() - t0, "shards": DATA_SHARDS,
              "clips_per_shard": DATA_CLIPS_PER_SHARD, "cpu_count": os.cpu_count()}
    first_shard = shards.expand_shard_pattern(pattern)[0]
    samples = [s for _, s in shards.iter_tar_samples(first_shard)]
    stereo, mono = samples[0], samples[-1]

    # the native resampler against scipy's resample_poly on this host
    rng = np.random.default_rng(7)
    wav44 = decode.decode_audio(stereo)[0][:1]
    wav48 = rng.uniform(-0.5, 0.5, (1, 480000)).astype(np.float32)
    record["resample"] = {}
    for sr, wav in ((44100, wav44), (48000, wav48)):
        native = resample.resample_np(wav, sr, 16000)
        plain = resample.resample_np_plain(wav, sr, 16000)
        err = float(np.abs(native - plain).max())
        if native.shape != (1, 160000) or not err <= RESAMPLE_ATOL:
            raise AssertionError(f"resample {sr} -> 16000: shape {native.shape}, "
                                 f"max |native - plain| {err} > {RESAMPLE_ATOL}")
        row = {"max_abs_err": err,
               "native_ms": median_ms(lambda: resample.resample_np(wav, sr, 16000), 10),
               "plain_ms": median_ms(lambda: resample.resample_np_plain(wav, sr, 16000), 2)}
        record["resample"][str(sr)] = row
        print(f"[data] resample {sr} -> 16000, 10 s: max |native - plain| {err:.3g} (limit "
              f"{RESAMPLE_ATOL}); native {row['native_ms']:.2f} ms, scipy resample_poly "
              f"{row['plain_ms']:.2f} ms", flush=True)

    # one worker's work a clip: decode, first channel, resample, normalize, int16
    def worker_clip(sample):
        wav, sr = decode.decode_audio(sample)
        wav = wav[:1]
        if sr != 16000:
            wav = resample.resample_np(wav, sr, 16000)
        return pipeline.quantize_clip_int16(pipeline.preprocess_clip(wav, 16000, 10.0))

    record["worker_ms"] = {
        "wav44k_stereo": median_ms(lambda: worker_clip(stereo), 10),
        "wav16k_mono": median_ms(lambda: worker_clip(mono), 10),
        "decode_wav44k_stereo": median_ms(lambda: decode.decode_audio(stereo), 10),
    }
    mix = (3 * record["worker_ms"]["wav44k_stereo"] + record["worker_ms"]["wav16k_mono"]) / 4
    record["worker_ms"]["shard_mix"] = mix
    print(f"[data] one worker a clip: 44.1k stereo {record['worker_ms']['wav44k_stereo']:.2f} ms "
          f"(decode {record['worker_ms']['decode_wav44k_stereo']:.2f}), 16k mono "
          f"{record['worker_ms']['wav16k_mono']:.2f} ms; the shards' mix {mix:.2f} ms, "
          f"{1e3 / mix:.1f} clips/s a worker", flush=True)

    default_path = dict(zip(counters, (36, 24, 0, 0)))
    train = phase_train(counters, [
        ("shards_accum_auto", [], TRAIN_STEPS, default_path, False),
        ("shards_accum_1", ["trainer.accum_steps=1"], TRAIN_STEPS_ONE_PASS, DECODER_REPLAYED,
         False),
    ], shards=pattern)
    # the loader, measured while it primed for the first shard-fed run: its
    # first batch (the workers' spawn and the shuffle buffer), as the loop
    # takes it, and the clips it produced a second into its queue
    cfg = apply_overrides(Config(), [f"data.data_dirs={pattern}"])
    b, workers = cfg.trainer.batch_size, cfg.data.num_workers
    primed = train["shards_accum_auto"]["primed"]
    if primed["first"] != {"shape": [b, 1, 160000], "dtype": "int16", "peak": 32767}:
        raise AssertionError(f"loader's first batch {primed['first']}")
    card = {name: synthetic_runs[name]["clips_per_s"] for name in ("accum_auto", "accum_1")}
    record["loader"] = {"workers": workers, "batch": b,
                        "first_batch_s": primed["buffer_s"],
                        "produced_clips_per_s": primed["produced_clips_per_s"],
                        "card_clips_per_s_phase5": card}
    print(f"[data] loader, {workers} worker processes (spawn) on a host of {os.cpu_count()} "
          f"CPUs, primed before shards_accum_auto: first batch of {b} after "
          f"{primed['buffer_s']:.2f} s (spawn, {cfg.data.shuffle_buffer}-clip shuffle buffer), "
          f"then {primed['produced_clips_per_s']:.1f} clips/s produced into its queue (to "
          f"{primed['queue']} clips); the card consumes {card['accum_auto']:.1f} clips/s at "
          f"accum 16 and {card['accum_1']:.1f} at accum 1 (phase 5, this run)", flush=True)
    for name, synthetic in (("shards_accum_auto", "accum_auto"), ("shards_accum_1", "accum_1")):
        r, base = train[name], synthetic_runs[synthetic]
        print(f"[data] {name} beside phase 5's synthetic clips: step p50 "
              f"{r['step_p50_ms']:.1f} vs {base['step_p50_ms']:.1f} ms, {r['clips_per_s']:.2f} vs "
              f"{base['clips_per_s']:.2f} clips/s, peak memory "
              f"{r['max_memory_allocated_bytes'] / 2**30:.2f} vs "
              f"{base['max_memory_allocated_bytes'] / 2**30:.2f} GiB; the loop waited "
              f"{r['data_wait_p50_ms']:.2f} vs {base['data_wait_p50_ms']:.2f} ms a step for its "
              f"batch (p50 after {TRAIN_WARMUP} steps; each step's: "
              f"{', '.join(f'{x:.1f}' for x in r['data_wait_ms'])}); the loader kept the "
              f"prefetch waiting {', '.join(f'{x:.1f}' for x in r['loader_wait_ms'])} ms "
              f"a batch, after filling the shuffle buffer in {r['primed']['buffer_s']:.2f} s "
              f"and its queue to {r['primed']['queue']} clips in {r['primed']['queue_s']:.2f} s",
              flush=True)

    # the CLI as users run it (its main, in this process), with the memory
    # this process's allocator keeps cached handed back to the card
    torch.cuda.empty_cache()
    cli_dir = os.path.join("build", "chip_smoke_train", "cli")
    shutil.rmtree(cli_dir, ignore_errors=True)
    argv = [f"data.data_dirs={pattern}", f"trainer.steps={CLI_STEPS}", "trainer.log_every=1",
            "optimizer.warmup_steps=2", f"trainer.save_dir={cli_dir}",
            f"data.shuffle_buffer={CLI_SHUFFLE_BUFFER}"]
    rc, stdout, cli_s = cli_in_process("wavjepa_tpu_torch.train", argv)
    ckpts = [os.path.join(d, f) for d, _, fs in os.walk(cli_dir) for f in fs
             if f == f"step_{CLI_STEPS:08d}.ckpt"]
    if rc != 0 or f"[step {CLI_STEPS}] loss=" not in stdout or not ckpts:
        raise AssertionError(f"CLI from shards: exit {rc}, checkpoints {ckpts}\n"
                             f"{stdout[-3000:]}")
    losses = [float(line.split("loss=")[1].split()[0]) for line in stdout.splitlines()
              if line.startswith("[step ")]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"CLI from shards: losses {losses}")
    record["cli"] = {"argv": argv, "seconds": cli_s, "losses": losses}
    print(f"[data] CLI from shards (its main in this process): {CLI_STEPS} steps, losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}, checkpoint written; {cli_s:.1f} s",
          flush=True)
    shutil.rmtree(cli_dir)  # ~1.7 GB of checkpoint
    shutil.rmtree(DATA_DIR)
    return record, train


def phase_trace(synthetic_runs: dict, shard_runs: dict) -> dict:
    """Phase 8: one train step at accum 16 and one at accum 1 (synthetic
    clips, default attention) under torch.profiler, after warm-up steps:
    its wall time, the card's busy and idle share, the kernels it launched,
    the top kernels by time and the top host operators by self time; then
    the MFU of phases 5 and 7."""
    from wavjepa_tpu_torch.train.config import Config, apply_overrides
    from wavjepa_tpu_torch.train.loop import build_data_iterator, build_run, step_seed
    from wavjepa_tpu_torch.utils import flops, profiling

    with profiling.trace(TRACE_DIR, name="profiler_warmup"):  # CUPTI's start-up, not timed
        torch.ones(1024, 1024, device="cuda").sum().item()
    os.remove(os.path.join(TRACE_DIR, "profiler_warmup.json.gz"))
    record = {}
    for name, extra in (("accum_auto", []), ("accum_1", ["trainer.accum_steps=1"])):
        cfg = apply_overrides(Config(), ["data.synthetic=true", "optimizer.warmup_steps=2",
                                         *extra])
        dev, model_cfg, state, step_fn = build_run(cfg, "cuda")
        batch = torch.from_numpy(next(build_data_iterator(cfg))).to(dev)
        generator = torch.Generator(device=dev)
        untraced = []
        for i in range(TRACE_WARMUP + 1):
            t0 = time.perf_counter()
            generator.manual_seed(step_seed(cfg.trainer.seed, state.step))
            state, m = step_fn(state, batch, generator)
            float(m["loss"])
            torch.cuda.synchronize()
            untraced.append((time.perf_counter() - t0) * 1e3)
        trace_name = f"train_step_{name}"
        t0 = time.perf_counter()
        with profiling.trace(TRACE_DIR, name=trace_name) as prof:
            with torch.profiler.record_function("train_step"):
                generator.manual_seed(step_seed(cfg.trainer.seed, state.step))
                state, m = step_fn(state, batch, generator)
                loss = float(m["loss"])
                torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(TRACE_DIR, f"{trace_name}.json.gz")
        summary = profiling.trace_summary(path, window="train_step", top=10)
        if not summary["kernels"] or not np.isfinite(loss):
            raise AssertionError(f"trace {name}: {summary['kernels']} kernels, loss {loss}")
        host = sorted((e for e in prof.key_averages()  # operators, not named ranges
                       if e.key != "train_step" and not getattr(e, "is_user_annotation", False)),
                      key=lambda e: -e.self_cpu_time_total)[:5]
        a = cfg.resolved_accum_steps()
        crops = cfg.trainer.batch_size * cfg.data.samples_per_audio
        rec = {"accum_steps": a, "loss": loss, "untraced_ms": untraced[-1],
               "traced_wall_ms": traced_ms, **summary,
               "kernels_per_microbatch": summary["kernels"] / a,
               "top_host_ops": [(e.key, e.count, e.self_cpu_time_total) for e in host],
               "trace_file": path, "trace_bytes": os.path.getsize(path),
               "step_flops": flops.jepa_step_flops(model_cfg, crops)}
        record[name] = rec
        print(f"[trace] {name} ({a} microbatches): step {untraced[-1]:.1f} ms untraced, "
              f"{traced_ms:.1f} ms traced (window {summary['wall_us'] / 1e3:.1f} ms); card busy "
              f"{summary['busy_us'] / 1e3:.1f} ms, idle share {summary['idle_share']:.3f}; "
              f"kernels {summary['kernels']} ({rec['kernels_per_microbatch']:.0f} a microbatch), "
              f"summed {summary['kernel_us'] / 1e3:.1f} ms; copies {summary['copies']}; "
              f"trace {path} ({rec['trace_bytes'] / 2**20:.1f} MiB)", flush=True)
        print(f"[trace] {name} kernel time by class: " + ", ".join(
            f"{cls} {us / 1e3:.1f} ms" for cls, us in summary["kernel_us_by_class"].items()))
        for kname, n, us in summary["top_kernels"]:
            print(f"[trace] {name} kernel {us / 1e3:8.2f} ms {n:6d}x  {kname[:110]}")
        for key, n, us in rec["top_host_ops"]:
            print(f"[trace] {name} host op self {us / 1e3:8.2f} ms {n:6d}x  {key[:110]}")
        del state, step_fn, batch, prof
        torch.cuda.empty_cache()
    flop = record["accum_auto"]["step_flops"]
    runs = {f"phase 5 {k}": synthetic_runs[k] for k in ("accum_auto", "accum_1")}
    runs.update({f"phase 7 {k}": shard_runs[k] for k in ("shards_accum_auto", "shards_accum_1")})
    record["mfu"] = {k: r["mfu"] for k, r in runs.items()}
    print(f"[trace] MFU ({flop / 1e12:.2f} TFLOP of useful work a step / step p50 / "
          f"{flops.H100_BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s): "
          + ", ".join(f"{k} {r['mfu']:.4f} ({r['step_p50_ms']:.1f} ms)" for k, r in runs.items()),
          flush=True)
    return record

def nat_scene_batch(seed: int, b: int = 32, seconds: float = 10.0, sr: int = 32000,
                    rir_s: float = 2.0, n_noise: int = 5, channels: int = 2) -> dict:
    """A Nat scene batch at the real shape from seeded numpy: clean clips,
    RIRs of ``channels`` (an onset, then exponentially decaying noise a channel),
    noise over a random span, SNRs in [-5, 5] dB; 2 of the 5 noise sources
    absent (zero rows)."""
    rng = np.random.default_rng(seed)
    t, length = int(sr * seconds), int(sr * rir_s)
    decay = np.exp(-np.arange(length) / (0.05 * sr)).astype(np.float32)

    def rirs(*shape):
        r = rng.standard_normal(shape + (length,)).astype(np.float32) * decay * 0.05
        r[..., int(rng.integers(0, 200))] += 1.0
        return r

    nrirs = rirs(b, n_noise, channels)
    nrirs[:, 3:] = 0.0
    start = rng.integers(0, t // 2, b).astype(np.int32)
    length_n = rng.integers(t // 4, t // 2, b).astype(np.int32)
    noise = np.zeros((b, t), np.float32)
    for i in range(b):
        noise[i, start[i]:start[i] + length_n[i]] = rng.standard_normal(length_n[i])
    return {"audio": rng.standard_normal((b, t)).astype(np.float32) * 0.1,
            "source_rir": rirs(b, channels), "noise": noise, "noise_rirs": nrirs,
            "noise_start": start, "noise_length": length_n,
            "snr": rng.uniform(-5, 5, b).astype(np.float32)}


def phase_nat_scenes() -> dict:
    """The Nat step's scene synthesis and resampler on one batch at the real
    shape: card against CPU, and the resampler against scipy with TF32
    turned on in the process (it turns it off for itself); then their card
    times, the step's scene build from inline RIRs and from the bank, and
    the convolution pair at each FFT length of NAT_FFT_LENGTHS."""
    from wavjepa_tpu_torch.data.resample import resample_np_plain
    from wavjepa_tpu_torch.ops import scenes
    from wavjepa_tpu_torch.ops.resample import resample_torch
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config
    from wavjepa_tpu_torch.train.loop import scene_config
    from wavjepa_tpu_torch.train.step import make_jepa_train_step

    cfg = apply_overrides(load_config(NAT_RECIPE), ["data.synthetic=true"])
    model_cfg = cfg.build_model_config()
    step = make_jepa_train_step(cfg.optimizer, scene_cfg=scene_config(cfg))
    batch = nat_scene_batch(21)
    card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    cpu = {k: torch.from_numpy(v) for k, v in batch.items()}
    sr_in, sr_out = step.scene_cfg.original_sr, model_cfg.sample_rate
    args = ("audio", "source_rir", "noise", "noise_rirs", "noise_start", "noise_length", "snr")

    def synth(b):
        return scenes.generate_scene(*(b[k] for k in args), with_rir=True, with_noise=True,
                                     n_channels=2)

    rec = {"batch": {k: list(v.shape) for k, v in batch.items()},
           "fft_len": scenes._fft_len(batch["audio"].shape[-1] + batch["source_rir"].shape[-1] - 1)}
    wet = synth(card)
    wet_cpu = synth(cpu)
    rec["scene_max_abs_err"], ok = scaled_err(wet.cpu(), wet_cpu, NAT_SCENE_REL)
    if tuple(wet.shape) != (32, 2, 320000) or not torch.isfinite(wet).all() or not ok:
        raise AssertionError(f"nat scenes {tuple(wet.shape)}: card vs CPU "
                             f"{rec['scene_max_abs_err']}")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # what a user's run may have
    try:
        res = resample_torch(wet, sr_in, sr_out)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    plain = torch.from_numpy(resample_np_plain(wet.cpu().numpy(), sr_in, sr_out))
    rec["resample_max_abs_err"], ok = scaled_err(res.cpu(), plain, NAT_RESAMPLE_REL)
    if tuple(res.shape) != (32, 2, 160000) or not ok:
        raise AssertionError(f"nat resampler {tuple(res.shape)}: card vs scipy "
                             f"{rec['resample_max_abs_err']} (TF32 on in the process)")
    rec["scene_ms"] = cuda_ms(lambda: synth(card), iters=10)
    rec["resample_ms"] = cuda_ms(lambda: resample_torch(wet, sr_in, sr_out), iters=10)
    rec["step_scenes_inline_ms"] = cuda_ms(lambda: step.scenes(model_cfg, card), iters=10)
    # the same clips with RIRs and noise from a 64-row device bank (int16 noise)
    bank = {"source_rir": card["source_rir"].repeat(2, 1, 1),
            "noise_rirs": card["noise_rirs"].repeat(2, 1, 1, 1),
            "noise": (card["noise"] * 3000).round().to(torch.int16).repeat(2, 1)}
    banked = {k: card[k] for k in ("audio", "noise_start", "noise_length", "snr")}
    banked["rir_index"] = torch.arange(32, device="cuda", dtype=torch.int32) * 2
    banked["noise_index"] = banked["rir_index"] + 1
    banked["noise_start"] = torch.zeros_like(banked["noise_start"])  # rows are placed
    rec["step_scenes_banked_ms"] = cuda_ms(lambda: step.scenes(model_cfg, banked, bank),
                                           iters=10)
    fft_len = scenes._fft_len
    rec["fft_pair_ms"] = {}
    try:
        for n in NAT_FFT_LENGTHS:
            scenes._fft_len = lambda m, n=n: n  # noqa: E731 - the length under test
            rec["fft_pair_ms"][n] = cuda_ms(lambda: (
                scenes.convolve_with_rir(card["audio"], card["source_rir"]),
                scenes.aggregate_noise(card["noise_rirs"], card["noise"])), iters=10)
    finally:
        scenes._fft_len = fft_len
    print(f"[nat scenes] {rec['batch']['audio']} clips at {sr_in} Hz, RIRs "
          f"{rec['batch']['source_rir']}, noise RIRs {rec['batch']['noise_rirs']}: scenes card vs "
          f"CPU max abs err {rec['scene_max_abs_err']:.3g} (limit {NAT_SCENE_REL} of max(1, "
          f"max |CPU|)); resampler {sr_in} -> {sr_out} vs scipy {rec['resample_max_abs_err']:.3g} "
          f"(limit {NAT_RESAMPLE_REL}, TF32 on in the process); scene synthesis "
          f"{rec['scene_ms']:.3f} ms (FFT length {rec['fft_len']}), resampler "
          f"{rec['resample_ms']:.3f} ms; the step's scene build {rec['step_scenes_inline_ms']:.3f} "
          f"ms inline, {rec['step_scenes_banked_ms']:.3f} ms from the bank", flush=True)
    print("[nat scenes] convolution pair by FFT length: " + ", ".join(
        f"{n} {ms:.3f} ms" for n, ms in rec["fft_pair_ms"].items()), flush=True)
    del step, card, wet, res, bank, banked
    torch.cuda.empty_cache()
    return rec


def npy_tar(path: str, arrays) -> None:
    """A tar of .npy members, one an array."""
    import io
    import tarfile

    with tarfile.open(path, "w") as tar:
        for i, arr in enumerate(arrays):
            buf = io.BytesIO()
            np.save(buf, arr)
            info = tarfile.TarInfo(f"item{i:04d}.npy")
            info.size = buf.tell()
            buf.seek(0)
            tar.addfile(info, buf)


def write_rir_shards(root: str, rng, channels: int) -> str:
    """4 .npy tars of NAT_RIR_STACKS RIR stacks in all ((1 + 0..5,
    channels, 64000) f32: the source's, then the noise sources'; an onset,
    then decaying noise; 2 channels binaural, 4 ambisonic). Returns their
    pattern."""
    os.makedirs(root, exist_ok=True)
    decay = np.exp(-np.arange(64000) / 1600.0).astype(np.float32)
    for s in range(4):
        stacks = []
        for _ in range(NAT_RIR_STACKS // 4):
            st = rng.standard_normal((1 + int(rng.integers(0, 6)), channels, 64000)).astype(
                np.float32) * decay * 0.05
            st[..., int(rng.integers(0, 200))] += 1.0
            stacks.append(st)
        npy_tar(os.path.join(root, f"rir-{s}.tar"), stacks)
    return os.path.join(root, "rir-{0..3}.tar")


def write_nat_shards(root: str, seed: int = 0) -> tuple[str, str, str]:
    """Phase 9's shards, which phases 9b and 10 read too: the clean clips of
    phase 7 (``write_shards``), binaural RIR stacks (``write_rir_shards``)
    and 1 .npy tar of noise rows of 3-15 s at 32 kHz. Returns their
    patterns."""
    audio = write_shards(os.path.join(root, "audio"), seed)
    rng = np.random.default_rng(seed + 1)
    rir = write_rir_shards(root, rng, 2)
    npy_tar(os.path.join(root, "noise-0.tar"), [
        rng.standard_normal(int(32000 * rng.uniform(3, 15))).astype(np.float32)
        for _ in range(NAT_NOISE_ROWS)])
    return audio, rir, os.path.join(root, "noise-0.tar")


def phase_nat_serve(counted, idle) -> dict:
    """The Nat HEAR runtime (``api/hear_natjepa.load_model``, bf16, binaural
    positions, seeded random weights): scene embeddings of 8 binaural clips
    of 10 s and timestamp embeddings of a ragged binaural batch, and one
    4-channel model (time positions) on 2 clips of 10 s; the flash forward
    once per encoder layer per request, the fused block never; then f32 on
    the card against the CPU and bf16 against that f32 result."""
    from wavjepa_tpu_torch.api import hear_natjepa
    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model
    from wavjepa_tpu_torch.models.jepa import JEPAConfig

    def clips(seconds, seed, channels=2):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal((channels, int(round(s * 16000)))).astype(np.float32) * 0.1
                for s in seconds]

    binaural = hear_natjepa.load_model("", pos_embed="binaural", seed=0)
    ambisonic = hear_natjepa.load_model("", in_channels=4, pos_embed="time", seed=0)
    layers = binaural.config.encoder_layers
    requests = [("scene_8x10s", binaural, "scene", clips([10.0] * 8, 31)),
                ("timestamps_ragged", binaural, "timestamps", clips([1.0, 2.01, 4.3, 30.0], 32)),
                ("ambisonic_timestamps_2x10s", ambisonic, "timestamps",
                 clips([10.0] * 2, 33, channels=4))]
    record = {}
    counted.launches = idle.launches = 0  # the main path's run starts here
    for name, rt, kind, x in requests:
        before = counted.launches
        emb, ts = serve_request(rt, kind, x)
        torch.cuda.synchronize()
        if counted.launches - before != layers or idle.launches:
            raise AssertionError(f"nat {name}: {counted.launches - before} flash launches, "
                                 f"expected {layers}, and {idle.launches} fused")
        n = max(c.shape[-1] for c in x)
        _, _, cut_off, _ = chunk_padding(n, rt.unit_frames, rt.sample_rate, rt.output_steps)
        expect = (len(x), rt.embedding_size) if kind == "scene" else (len(x), cut_off,
                                                                      rt.embedding_size)
        if tuple(emb.shape) != expect or not torch.isfinite(emb).all():
            raise AssertionError(f"nat {name}: embeddings {tuple(emb.shape)} != {expect}")
        if ts is not None and tuple(ts.shape) != expect[:2]:
            raise AssertionError(f"nat {name}: timestamps {tuple(ts.shape)}")
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            serve_request(rt, kind, x)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        record[name] = {"shape": list(emb.shape), "channels": rt.in_channels,
                        "tokens_per_window": rt.config.total_patches,
                        "p50_ms": statistics.median(times), "n": len(times)}
        print(f"[nat serve] {name}: {rt.in_channels} channels, {rt.config.total_patches} "
              f"tokens a window, out {tuple(emb.shape)}, p50 {record[name]['p50_ms']:.3f} ms "
              f"over {len(times)} requests", flush=True)
    launches, idle_launches = counted.launches, idle.launches  # read just after
    if launches != layers * 13 * len(requests) or idle_launches:
        raise AssertionError(f"nat serving launched {launches} flash, {idle_launches} fused")
    record["launches"] = launches

    cfg = JEPAConfig(extractor="conv_channel", in_channels=2, pos_embed="binaural",
                     dtype=torch.float32)
    x = clips([2.01, 1.0], 34)
    e_card = load_model("", config=cfg, device="cuda", seed=0).get_timestamp_embeddings(x)[0].cpu()
    e_cpu = load_model("", config=cfg, device="cpu", seed=0).get_timestamp_embeddings(x)[0]
    err = (e_card - e_cpu).abs().max().item()
    if not torch.allclose(e_card, e_cpu, atol=CARD_CPU_ATOL, rtol=CARD_CPU_ATOL):
        raise AssertionError(f"nat f32 card vs CPU: max abs err {err}")
    e_bf16 = binaural.get_timestamp_embeddings(x)[0].cpu()
    rel = (torch.linalg.norm(e_bf16 - e_card) / torch.linalg.norm(e_card)).item()
    if not rel <= BF16_REL_FRO:
        raise AssertionError(f"nat bf16 vs f32: relative Frobenius {rel}")
    record["parity"] = {"f32_card_vs_cpu_max_abs_err": err, "bf16_vs_f32_rel_fro": rel,
                        "shape": list(e_card.shape)}
    print(f"[nat serve] f32 card vs CPU max abs err {err:.3g} (atol {CARD_CPU_ATOL}); bf16 vs "
          f"f32 relative Frobenius {rel:.4g} (limit {BF16_REL_FRO}), {tuple(e_card.shape)}",
          flush=True)
    return record


def nat_launches(counters: dict, model_cfg) -> dict:
    """Launches of each counted wrapper a microbatch of a Nat step on the
    default path: the student encoder, the teacher and the predictor
    forward, the student encoder and the predictor backward (36 and 24 at
    base width, nothing replayed)."""
    enc, dec = model_cfg.encoder_layers, model_cfg.decoder_layers
    return dict(zip(counters, (2 * enc + dec, enc + dec, 0, 0)))


def nat_runs(counters: dict, prefix: str, items: list, shards: tuple,
             keep: dict = None) -> dict:
    """NAT_RECIPE with ``items`` at base width: ``train_jepa`` on synthetic
    scene batches, its checkpoint served here, or moved as ``keep`` says
    for a later phase to serve; one f32 step card against CPU and bf16
    against it (phase 6's); then ``train_jepa`` from ``shards`` (the
    patterns of the clean clips, the RIR stacks and the noise) with the
    device banks and one refresh a batch. Both runs NAT_STEPS steps with
    phase 5's checks at a Nat microbatch's launches."""
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config

    per_microbatch = nat_launches(
        counters, apply_overrides(load_config(NAT_RECIPE), items).build_model_config())
    record = {"per_microbatch": per_microbatch}
    name = f"{prefix}_accum_auto"
    record["train"] = phase_train(counters, [(name, items, NAT_STEPS, per_microbatch,
                                              keep is None)],
                                  keep=keep, warmup=NAT_WARMUP, recipe=NAT_RECIPE)
    record["train_parity"] = phase_train_parity(tuple(items), f"{prefix} train parity",
                                                recipe=NAT_RECIPE)
    audio, rir, noise = shards
    shard_name = f"{prefix}_shards_accum_auto"
    record["train_shards"] = phase_train(counters, [
        (shard_name, [*items, f"data.rir_dir={rir}", f"data.noise_dir={noise}",
                      "data.rir_refresh_per_batch=1"], NAT_STEPS, per_microbatch, False)],
        shards=audio, warmup=NAT_WARMUP, recipe=NAT_RECIPE)
    run, shard_run = record["train"][name], record["train_shards"][shard_name]
    print(f"[{prefix}] from shards with device banks beside synthetic scenes: step p50 "
          f"{shard_run['step_p50_ms']:.1f} vs {run['step_p50_ms']:.1f} ms, "
          f"{shard_run['clips_per_s']:.2f} vs {run['clips_per_s']:.2f} clips/s; data wait "
          f"p50 {shard_run['data_wait_p50_ms']:.2f} ms a step (each step's: "
          f"{', '.join(f'{x:.1f}' for x in shard_run['data_wait_ms'])})", flush=True)
    return record


def phase_nat(counters: dict) -> dict:
    """Phase 9, WavJEPA-Nat (configs/nat_binaural.yaml at base width): the
    scene synthesis (``phase_nat_scenes``); ``nat_runs`` from shards written
    under NAT_SHARDS_DIR (kept for phases 9b and 10, which deletes them) at
    the resolved accumulation; the Nat HEAR runtime."""
    import shutil

    record = {"scenes": phase_nat_scenes()}
    shutil.rmtree(NAT_SHARDS_DIR, ignore_errors=True)
    record["shards"] = write_nat_shards(NAT_SHARDS_DIR)
    record.update(nat_runs(counters, "nat", [], record["shards"]))
    run = record["train"]["nat_accum_auto"]
    share = record["scenes"]["step_scenes_inline_ms"] / run["step_p50_ms"]
    record["scene_share_of_step"] = share
    print(f"[nat] scene build {record['scenes']['step_scenes_inline_ms']:.2f} ms of the "
          f"{run['step_p50_ms']:.1f}-ms step ({share:.4f})", flush=True)
    record["serve"] = phase_nat_serve(counters["flash_attention_fwd"],
                                      counters["fused_attention_block_fwd"])
    return record


# phase 9c (the microbatch graph): one Nat step as its cell runs it, through
# the graph and through the eager loop from one state; then steps timed in
# turns
GRAPH_SEED = 5
GRAPH_TIMED_STEPS = 3


def phase_microbatch_graph(counters: dict) -> dict:
    """Phase 9c: NAT_RECIPE as resolved (base width, 32 clips × 8 crops,
    bf16, packing 176/256, 16 microbatches) through ``build_run``. From one
    seeded state and one scene batch, one step through the microbatch graph
    (``train/step.py``; it captures, its microbatch 0 eager) and one through
    the eager loop (the route's rule patched to say no), with the gathers'
    backward deterministic on both: the loss, the gradient norm, every
    gradient, weight, teacher leaf and AdamW moment bit for bit equal; each
    counted wrapper's launches equal on both routes and exactly a Nat
    microbatch's (``nat_launches``; the norm 75 forward and 51 backward) a
    microbatch; the counters 1 capture, 15 replays, 1 eager microbatch.
    Before that, from the same state in the default mode, a step a route
    (the graph captures) and GRAPH_TIMED_STEPS steps a route in turns: step
    p50, clips/s and the card's memory (each route's allocated peak, and
    the reserved memory, which holds the graph's pool)."""
    import copy
    import warnings

    from wavjepa_tpu_torch.ops import layer_norm
    from wavjepa_tpu_torch.train import step as train_step
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config
    from wavjepa_tpu_torch.train.loop import build_run
    from wavjepa_tpu_torch.utils import profiling

    cfg = apply_overrides(load_config(NAT_RECIPE), ["optimizer.warmup_steps=2"])
    dev, model_cfg, state, step_fn = build_run(cfg, "cuda")
    state.step = 1  # warmup_steps 2: a learning rate that moves the weights
    accum = step_fn.accum_steps
    batch = {k: torch.from_numpy(v).to(dev) for k, v in nat_scene_batch(GRAPH_SEED).items()}
    inputs = step_fn.prepare(model_cfg, step_fn.scenes(model_cfg, batch),
                             torch.Generator(dev).manual_seed(GRAPH_SEED))
    twin = copy.deepcopy(state)
    counted = {**counters, "layer_norm32_fwd": layer_norm.layer_norm32_fwd,
               "layer_norm32_bwd": layer_norm.layer_norm32_bwd}
    per_microbatch = {**nat_launches(counters, model_cfg),
                      **{f"layer_norm32_{k}": n for k, n in LAYER_NORM_PER_MICROBATCH.items()}}
    rule = train_step.microbatch_graph_route

    def step(st, graphed: bool) -> tuple:
        """One step on ``inputs``: (metrics, launches, counters, seconds)."""
        train_step.microbatch_graph_route = rule if graphed else (lambda *a: False)
        try:
            out = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profiling.recording() as rec:
                launches = counted_run(counted, lambda: out.append(
                    step_fn.step_on(st, *inputs)[1]))
            return out[0], launches, dict(rec.counters), time.perf_counter() - t0
        finally:
            train_step.microbatch_graph_route = rule

    def readings(st) -> dict:
        out = {f"weight {n}": p.detach().clone() for n, p in st.model.named_parameters()}
        out.update({f"grad {n}": p.grad.clone() for n, p in st.model.named_parameters()})
        out.update({f"teacher {n}": p.clone() for n, p in st.teacher_encoder.named_parameters()})
        out.update({f"adamw {k} {n}": v.clone() for n, p in st.model.named_parameters()
                    for k, v in st.optimizer.state[p].items() if torch.is_tensor(v)})
        return out

    # the default mode first: a step a route (the graph captures), then turns
    pristine = copy.deepcopy(state)
    for st, graphed_route in ((state, True), (twin, False)):
        step(st, graphed_route)
    times = {"graph": [], "eager": []}
    peaks = {}
    for _ in range(GRAPH_TIMED_STEPS):
        for st, name in ((state, "graph"), (twin, "eager")):
            torch.cuda.reset_peak_memory_stats()
            run = step(st, name == "graph")
            times[name].append(run[3] * 1e3)
            peaks[name] = torch.cuda.max_memory_allocated()
            if name == "graph" and run[2].get("train.graph_replay") != accum:
                raise AssertionError(f"microbatch graph: counters {run[2]}")
    reserved = torch.cuda.memory_reserved()
    # then the comparison from one state, the gathers' backward deterministic
    state, twin = pristine, copy.deepcopy(pristine)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        graphed = step(state, True)
        graphed_readings = readings(state)
        eager = step(twin, False)
        unequal = [k for k, v in readings(twin).items() if not torch.equal(v, graphed_readings[k])]
    finally:
        torch.use_deterministic_algorithms(False)
    del graphed_readings
    record = {"accum_steps": accum, "unequal": unequal[:20], "n_unequal": len(unequal),
              "loss": [float(graphed[0]["loss"]), float(eager[0]["loss"])],
              "grad_norm": [float(graphed[0]["grad_norm"]), float(eager[0]["grad_norm"])],
              "launches": {"graph": graphed[1], "eager": eager[1]},
              "counters": {"graph": graphed[2], "eager": eager[2]}}
    expected = {k: n * accum for k, n in per_microbatch.items()}
    counts = {k: graphed[2].get(f"train.{k}", 0)
              for k in ("graph_capture", "graph_replay", "microbatch_eager")}
    if (unequal or not torch.equal(graphed[0]["loss"], eager[0]["loss"])
            or not torch.equal(graphed[0]["grad_norm"], eager[0]["grad_norm"])):
        raise AssertionError(f"microbatch graph vs eager loop: {record}")
    if graphed[1] != expected or eager[1] != expected:
        raise AssertionError(f"microbatch graph: launches {record['launches']}, expected "
                             f"{expected}")
    if counts != {"graph_capture": 1, "graph_replay": accum - 1, "microbatch_eager": 1}:
        raise AssertionError(f"microbatch graph: counters {graphed[2]}")
    b = cfg.trainer.batch_size
    record.update(step_ms=times, step_p50_ms={k: statistics.median(v) for k, v in times.items()},
                  max_memory_allocated_bytes=peaks, memory_reserved_bytes=reserved)
    record["clips_per_s"] = {k: b / (v / 1e3) for k, v in record["step_p50_ms"].items()}
    print(f"[microbatch graph] Nat step at accum {accum}, graph vs eager from one state: "
          f"loss {record['loss'][0]!r} = {record['loss'][1]!r}, grad_norm equal, every "
          f"gradient, weight, teacher leaf and AdamW moment equal (deterministic gathers); "
          f"launches a step {graphed[1]} on both routes; counters {counts}; step p50 "
          f"{record['step_p50_ms']['graph']:.1f} vs {record['step_p50_ms']['eager']:.1f} ms "
          f"({record['clips_per_s']['graph']:.2f} vs {record['clips_per_s']['eager']:.2f} "
          f"clips/s); peak allocated {peaks['graph'] / 2**30:.2f} vs "
          f"{peaks['eager'] / 2**30:.2f} GiB, reserved "
          f"{record['memory_reserved_bytes'] / 2**30:.2f} GiB", flush=True)
    del state, twin, step_fn, inputs
    torch.cuda.empty_cache()
    return record


# phase 9b (ambisonic Nat): configs/nat_binaural.yaml at 4 channels with the
# 1-D time positions (the binaural table holds 2·T rows, so both packages
# refuse it at 4 channels); (b)'s checkpoint and the 4-channel shards under
# build/, deleted at the end
AMBISONIC = ("data.in_channels=4", "extractor.pos_embed=time")
AMBISONIC_DIR = os.path.join("build", "chip_smoke_ambisonic")
AMBISONIC_REQUEST = (2, 10.0)  # (e): 2 four-channel clips of 10 s


def ambisonic_shapes(cfg) -> list:
    """(name, B, H, T, d) of the flash kernels' calls in a microbatch of
    ``cfg`` as resolved, in AMBISONIC_ATTN_SHAPES' order: the packed
    student encoder, the packed predictor (a group a target) and the
    teacher on every token."""
    m = cfg.build_model_config()
    mb = cfg.trainer.batch_size * cfg.data.samples_per_audio // cfg.resolved_accum_steps()
    groups = cfg.masker.target_masks_per_context
    calls = [(mb, m.encoder_heads, m.pack_encoder, m.encoder_dim // m.encoder_heads),
             (mb * groups, m.decoder_heads, m.pack_decoder, m.decoder_dim // m.decoder_heads),
             (mb, m.encoder_heads, m.total_patches, m.encoder_dim // m.encoder_heads)]
    return [(name, *call) for (name, *_), call in zip(AMBISONIC_ATTN_SHAPES, calls)]


def phase_ambisonic_serve(counters: dict, ckpt: str) -> dict:
    """Phase 9b(e): (b)'s checkpoint served by ``api/hear_natjepa.load_model``
    (the sidecar's 4 channels and time positions, bf16): timestamp
    embeddings of AMBISONIC_REQUEST, channel-averaged (B, S, D), the flash
    forward once per encoder layer, nothing else; then the same weights in
    f32 on the card against the CPU (phase 4's atol) and bf16 against that
    f32 result (phase 4's relative Frobenius)."""
    from wavjepa_tpu_torch.api import hear_natjepa
    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model

    rt = hear_natjepa.load_model(ckpt, in_channels=4)
    if (rt.in_channels, rt.config.pos_embed, rt.config.dtype) != (4, "time", torch.bfloat16):
        raise AssertionError(f"ambisonic checkpoint served as {rt.config}")
    n, seconds = AMBISONIC_REQUEST
    rng = np.random.default_rng(35)
    x = [rng.standard_normal((4, int(seconds * 16000))).astype(np.float32) * 0.1
         for _ in range(n)]
    served = {}
    launches = counted_run(counters, lambda: served.setdefault(
        "out", rt.get_timestamp_embeddings(x)))
    emb, ts = served["out"]
    _, _, cut_off, _ = chunk_padding(x[0].shape[-1], rt.unit_frames, rt.sample_rate,
                                     rt.output_steps)
    expect = (n, cut_off, rt.config.encoder_dim)
    if (tuple(emb.shape) != expect or tuple(ts.shape) != expect[:2]
            or not torch.isfinite(emb).all()):
        raise AssertionError(f"ambisonic served {tuple(emb.shape)}, expected {expect}")
    if launches != dict(zip(counters, (rt.config.encoder_layers, 0, 0, 0))):
        raise AssertionError(f"ambisonic serving launched {launches}")
    times = []
    for i in range(7):
        t0 = time.perf_counter()
        rt.get_timestamp_embeddings(x)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    f32_cfg = dataclasses.replace(rt.config, dtype=torch.float32)
    e_card = load_model(ckpt, config=f32_cfg, device="cuda").get_timestamp_embeddings(x)[0].cpu()
    e_cpu = load_model(ckpt, config=f32_cfg, device="cpu").get_timestamp_embeddings(x)[0]
    err = (e_card - e_cpu).abs().max().item()
    if not torch.allclose(e_card, e_cpu, atol=CARD_CPU_ATOL, rtol=CARD_CPU_ATOL):
        raise AssertionError(f"ambisonic checkpoint, f32 card vs CPU: max abs err {err}")
    rel = (torch.linalg.norm(emb.float().cpu() - e_card) / torch.linalg.norm(e_card)).item()
    if not rel <= BF16_REL_FRO:
        raise AssertionError(f"ambisonic checkpoint, bf16 vs f32: relative Frobenius {rel}")
    record = {"shape": list(emb.shape), "tokens_per_window": rt.config.total_patches,
              "launches": launches, "p50_ms": statistics.median(times), "n": len(times),
              "f32_card_vs_cpu_max_abs_err": err, "bf16_vs_f32_rel_fro": rel}
    print(f"[ambisonic serve] (b)'s checkpoint by hear_natjepa.load_model: {n} clips of "
          f"{seconds} s × 4 channels, {rt.config.total_patches} tokens a window, out "
          f"{tuple(emb.shape)}, p50 {record['p50_ms']:.3f} ms over {len(times)} requests, "
          f"launches {launches}; f32 card vs CPU max abs err {err:.3g} (atol {CARD_CPU_ATOL}); "
          f"bf16 vs f32 relative Frobenius {rel:.4g} (limit {BF16_REL_FRO})", flush=True)
    del rt
    return record


def phase_ambisonic(counters: dict, nat: dict) -> dict:
    """Phase 9b, the ambisonic Nat configuration (NAT_RECIPE with
    AMBISONIC) at base width: the flash shapes it resolves to against
    AMBISONIC_ATTN_SHAPES (held in phase 2); the step's scene build from a
    4-channel batch at the real shape; ``nat_runs`` with 4-channel RIR
    stacks ((b) synthetic scenes, its checkpoint kept; (c) the f32 step
    card against CPU, bf16 against f32; (d) from shards); (e)
    ``phase_ambisonic_serve`` of (b)'s checkpoint. Beside phase 9's
    binaural step (``nat``)."""
    import shutil

    from wavjepa_tpu_torch.train.config import apply_overrides, load_config
    from wavjepa_tpu_torch.train.loop import scene_config
    from wavjepa_tpu_torch.train.step import make_jepa_train_step

    shutil.rmtree(AMBISONIC_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    seconds = {}  # each part's end, from the phase's start

    def part(name):
        seconds[name] = time.perf_counter() - t0

    record = {"card": card_line(), "seconds": seconds}
    cfg = apply_overrides(load_config(NAT_RECIPE), [*AMBISONIC, "data.synthetic=true"])
    model_cfg = cfg.build_model_config()
    shapes = ambisonic_shapes(cfg)
    if shapes != AMBISONIC_ATTN_SHAPES:
        raise AssertionError(f"ambisonic configuration resolves to {shapes}, phase 2 held "
                             f"{AMBISONIC_ATTN_SHAPES}")
    record["shapes"] = shapes

    # the step's scene build from a 4-channel batch at the real shape
    step = make_jepa_train_step(cfg.optimizer, scene_cfg=scene_config(cfg))
    card = {k: torch.from_numpy(v).cuda() for k, v in nat_scene_batch(22, channels=4).items()}
    scene = step.scenes(model_cfg, card)
    if tuple(scene.shape) != (32, 4, 160000) or not torch.isfinite(scene).all():
        raise AssertionError(f"ambisonic scenes {tuple(scene.shape)}")
    record["step_scenes_inline_ms"] = cuda_ms(lambda: step.scenes(model_cfg, card), iters=10)
    del step, card, scene
    torch.cuda.empty_cache()
    part("scenes")

    # phase 9's clean clips and noise, with 4-channel RIR stacks
    audio, _, noise = nat["shards"]
    rir = write_rir_shards(os.path.join(AMBISONIC_DIR, "rirs"), np.random.default_rng(23), 4)
    record.update(nat_runs(counters, "ambisonic", list(AMBISONIC), (audio, rir, noise),
                           keep={"ambisonic_accum_auto": AMBISONIC_DIR}))
    part("runs")
    run, per_microbatch = record["train"]["ambisonic_accum_auto"], record["per_microbatch"]
    per_step = {k: n // NAT_STEPS for k, n in run["launches"].items()}
    share = record["step_scenes_inline_ms"] / run["step_p50_ms"]
    record.update(launches_per_step=per_step, scene_share_of_step=share)
    binaural = nat["train"]["nat_accum_auto"]
    print(f"[ambisonic] (b) {run['accum_steps']} microbatches of {shapes[0][1]} crops, flash "
          f"launches a step {per_step['flash_attention_fwd']} forward / "
          f"{per_step['flash_attention_bwd']} backward ({per_microbatch['flash_attention_fwd']} / "
          f"{per_microbatch['flash_attention_bwd']} a microbatch); step p50 "
          f"{run['step_p50_ms']:.1f} ms, {run['clips_per_s']:.2f} clips/s, "
          f"{run['crops_per_s']:.1f} crops/s, MFU {run['mfu']:.4f} of {run['step_tflop']:.2f} "
          f"TFLOP, peak memory {run['max_memory_allocated_bytes'] / 2**30:.2f} GiB; scene build "
          f"{record['step_scenes_inline_ms']:.2f} ms ({share:.4f} of the step); phase 9's "
          f"binaural step {binaural['step_p50_ms']:.1f} ms, MFU {binaural['mfu']:.4f}, "
          f"{binaural['max_memory_allocated_bytes'] / 2**30:.2f} GiB; {record['card']}",
          flush=True)
    record["serve"] = phase_ambisonic_serve(
        counters, os.path.join(AMBISONIC_DIR, f"step_{NAT_STEPS:08d}.ckpt"))
    shutil.rmtree(AMBISONIC_DIR)  # ~1.7 GB of base-width checkpoint
    part("serve")
    print("[ambisonic] seconds from the phase's start at the end of each part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    return record


def denoise_config(save_dir: str, *extra):
    """The denoise CLI's configuration (``wavjepa_tpu_torch.denoise``: 8
    clips × 16 crops, accum 4, α = 0 at base width), writing under
    ``save_dir``, logging every step, the warmup cut to 2 steps."""
    from wavjepa_tpu_torch.denoise import denoise_config as cli_config

    return cli_config([f"trainer.save_dir={save_dir}", "trainer.log_every=1",
                       "optimizer.warmup_steps=2", *extra])


def write_denoise_teacher(path_dir: str) -> tuple[str, dict]:
    """A seeded JEPA at base width as a port training checkpoint (step 0),
    its EMA teacher moved apart from its student, so that a loader that took
    ``teacher_encoder.*`` would show. Returns the path and the file's
    state_dict."""
    from wavjepa_tpu_torch.models.jepa import JEPA
    from wavjepa_tpu_torch.train.checkpoint import CheckpointManager
    from wavjepa_tpu_torch.train.state import TrainState
    from wavjepa_tpu_torch.train.step import OptimizerConfig, make_optimizer

    cfg = denoise_config(path_dir, "data.synthetic=true")
    model = JEPA(cfg.build_denoise_model_config())
    model.init_parameters(torch.Generator().manual_seed(DENOISE_TEACHER_SEED))
    state = TrainState.create(model, make_optimizer(OptimizerConfig(), model))
    with torch.no_grad():
        g = torch.Generator().manual_seed(DENOISE_TEACHER_SEED + 1)
        for p in state.teacher_encoder.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
    mgr = CheckpointManager(os.path.join(path_dir, "ckpt"))
    mgr.save(0, state, force=True)
    path = str(mgr.path(0))
    return path, torch.load(path, map_location="cpu", weights_only=False)["state_dict"]


def phase_denoise_train(counters: dict, teacher_path: str, teacher_sd: dict, runs: list,
                        shards: tuple = ()) -> dict:
    """train_denoiser once per run (name, overrides, steps, launches of each
    counted wrapper a microbatch, whether to serve from its checkpoint),
    from ``teacher_path``, on synthetic scene batches or, given (audio, rir,
    noise) shard patterns, from the scene pipeline with device banks, primed
    as ``primed_shard_batches`` does; the launch counts are set to 0 just
    before each run and read just after it. Checks finite losses, the first
    step's loss_clean (the warm-started student is the teacher), the
    teacher bitwise as the file's student at the end, the student moved."""
    import shutil

    from wavjepa_tpu_torch.models.jepa import ENCODER_SIDE
    from wavjepa_tpu_torch.train import denoise_loop
    from wavjepa_tpu_torch.utils import flops

    record = {}
    for name, extra, steps, per_microbatch, serve in runs:
        save_dir = os.path.join(DENOISE_DIR, name)
        shutil.rmtree(save_dir, ignore_errors=True)
        source = (["data.synthetic=false", f"data.data_dirs={shards[0]}",
                   f"data.rir_dir={shards[1]}", f"data.noise_dir={shards[2]}",
                   "data.rir_refresh_per_batch=1"] if shards else ["data.synthetic=true"])
        cfg = denoise_config(save_dir, f"teacher_ckpt={teacher_path}", *source, *extra)
        model_cfg = cfg.build_denoise_model_config()
        a = cfg.resolved_denoise_accum_steps()
        data_iter, batches, loader_waits, primed = None, None, [], {}
        if shards:
            data_iter, batches, loader_waits, primed = primed_shard_batches(
                cfg, denoise_loop.build_denoise_data_iterator)
        teachers, load = [], denoise_loop.load_teacher

        def keep_teacher(*args, **kwargs):  # the run's frozen teacher, to check after it
            teachers.append(load(*args, **kwargs))
            return teachers[-1]

        denoise_loop.load_teacher = keep_teacher
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in counters.values():  # the main path's run starts here
            counter.launches = 0
        try:
            state = denoise_loop.train_denoiser(cfg, data_iter=data_iter, max_steps=steps,
                                                device="cuda")
            torch.cuda.synchronize()
        finally:
            denoise_loop.load_teacher = load
            if batches is not None:
                batches.stop()
        launches = {k: c.launches for k, c in counters.items()}  # read just after
        peak = torch.cuda.max_memory_allocated()
        expected = {k: n * a * steps for k, n in per_microbatch.items()}
        if launches != expected:
            raise AssertionError(f"denoise {name}: launches {launches}, expected {expected} "
                                 f"({a} microbatches)")
        run_dir = os.path.join(save_dir, "Denoise-" + cfg.run_identity())
        with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        losses = [line["loss"] for line in lines]
        if len(losses) != steps or not all(np.isfinite(losses)):
            raise AssertionError(f"denoise {name}: losses {losses}")
        if not lines[0]["loss_clean"] < DENOISE_FIRST_LOSS_CLEAN:
            raise AssertionError(f"denoise {name}: first step's loss_clean "
                                 f"{lines[0]['loss_clean']} (student = teacher there)")
        t_sd = teachers[0].state_dict()
        changed = [k for k, v in t_sd.items() if not torch.equal(v.cpu(), teacher_sd[k])]
        if changed or any(p.requires_grad for p in teachers[0].parameters()):
            raise AssertionError(f"denoise {name}: the teacher is not the file's student "
                                 f"after the run ({changed[:4]})")
        moved = sum((v.float().cpu() - teacher_sd[k]).abs().sum().item()
                    for k, v in state.student.state_dict().items())
        if not moved > 0:
            raise AssertionError(f"denoise {name}: the student did not move")
        times = [line["step_time_ms"] for line in lines[TRAIN_WARMUP:]]
        p50 = statistics.median(times)
        b, crops = cfg.trainer.batch_size, cfg.trainer.batch_size * cfg.data.samples_per_audio
        step_flops = flops.denoise_step_flops(model_cfg, crops, alpha=cfg.alpha,
                                              clean_forward=cfg.log_clean_loss)
        rec = {
            "accum_steps": a, "steps": steps, "alpha": cfg.alpha, "losses": losses,
            "loss_clean": [line["loss_clean"] for line in lines],
            "loss_denoise_dereverb": [line["loss_denoise_dereverb"] for line in lines],
            "grad_norms": [line["grad_norm"] for line in lines],
            "step_ms": [line["step_time_ms"] for line in lines], "step_p50_ms": p50,
            "clips_per_s": b / (p50 / 1e3), "crops_per_s": crops / (p50 / 1e3),
            "max_memory_allocated_bytes": peak, "launches": launches,
            "student_moved": moved, "teacher_unchanged": True,
            "data_wait_ms": [line["data_wait_ms"] for line in lines],
            "data_wait_p50_ms": statistics.median(
                line["data_wait_ms"] for line in lines[TRAIN_WARMUP:]),
            "step_flops": step_flops, "mfu": flops.mfu(step_flops, p50 / 1e3),
            "source": "shards" if shards else "synthetic",
        }
        if shards:
            rec["loader_wait_ms"], rec["primed"] = loader_waits, primed
        ckpt = os.path.join(run_dir, "ckpt", f"step_{steps:08d}.ckpt")
        if not os.path.isfile(ckpt):
            raise AssertionError(f"denoise {name}: no checkpoint {ckpt}")
        saved = torch.load(ckpt, map_location="cpu", weights_only=False)["state_dict"]
        if not saved or not all(k.startswith(ENCODER_SIDE) for k in saved):
            raise AssertionError(f"denoise {name}: checkpoint keys {sorted(saved)[:4]}...")
        if serve:
            rec["serve"] = phase_denoise_serve(counters["flash_attention_fwd"],
                                               counters["fused_attention_block_fwd"], ckpt)
        del state, teachers
        torch.cuda.empty_cache()
        shutil.rmtree(save_dir)  # ~1 GB of base-width checkpoint
        record[name] = rec
        print(f"[denoise] {name}: {steps} steps of {b} clips × {cfg.data.samples_per_audio} "
              f"crops, {a} microbatches, α {cfg.alpha}; losses "
              f"{', '.join(f'{x:.5f}' for x in losses)}; loss_clean at step 1 "
              f"{lines[0]['loss_clean']:.3g}; step p50 {p50:.1f} ms (after {TRAIN_WARMUP} "
              f"warm-up steps), {rec['clips_per_s']:.2f} clips/s, {rec['crops_per_s']:.1f} "
              f"crops/s, peak memory {peak / 2**30:.2f} GiB; launches {launches}; teacher "
              f"unchanged, student moved {moved:.4g}; {rec['source']}, data wait p50 "
              f"{rec['data_wait_p50_ms']:.2f} ms a step; MFU {rec['mfu']:.4f} "
              f"({step_flops / 1e12:.2f} TFLOP a step)", flush=True)
    return record


def phase_denoise_serve(counted, idle, ckpt: str) -> dict:
    """The distilled student's checkpoint served by ``load_model`` (the
    architecture from the run's model_config.json, bf16): scene embeddings
    of 8 clips of 10 s and timestamp embeddings of a ragged batch; the
    flash forward once per encoder layer per request, the fused block
    never."""
    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model

    rt = load_model(ckpt)
    layers = rt.config.encoder_layers
    record = {}
    counted.launches = idle.launches = 0  # the main path's run starts here
    for name, kind, clips in (("scene_8x10s", "scene", make_clips([10.0] * 8, 41)),
                              ("timestamps_ragged", "timestamps",
                               make_clips([1.0, 2.01, 4.3, 30.0], 42))):
        emb, ts = serve_request(rt, kind, clips)
        torch.cuda.synchronize()
        n = max(len(c) for c in clips)
        _, _, cut_off, _ = chunk_padding(n, rt.unit_frames, rt.sample_rate, rt.output_steps)
        expect = ((len(clips), rt.embedding_size) if kind == "scene"
                  else (len(clips), cut_off, rt.embedding_size))
        if tuple(emb.shape) != expect or not torch.isfinite(emb).all():
            raise AssertionError(f"denoise serve {name}: embeddings {tuple(emb.shape)} != "
                                 f"{expect} or not finite")
        if ts is not None and tuple(ts.shape) != expect[:2]:
            raise AssertionError(f"denoise serve {name}: timestamps {tuple(ts.shape)}")
        times = []
        for i in range(7):
            t0 = time.perf_counter()
            serve_request(rt, kind, clips)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        record[name] = {"shape": list(emb.shape), "p50_ms": statistics.median(times),
                        "n": len(times)}
    launches, idle_launches = counted.launches, idle.launches  # read just after
    if launches != layers * 8 * 2 or idle_launches:
        raise AssertionError(f"denoise serving launched {launches} flash forwards (expected "
                             f"{layers * 16}), {idle_launches} fused")
    record["launches"] = launches
    print(f"[denoise serve] the distilled student from its checkpoint ({rt.config.dtype}): "
          + ", ".join(f"{k} {tuple(v['shape'])} p50 {v['p50_ms']:.3f} ms"
                      for k, v in record.items() if k != "launches")
          + f"; {launches} flash forward launches ({layers} a request)", flush=True)
    return record


def phase_denoise_parity() -> dict:
    """One denoise step at base width from the same crops (α = 0.3, so both
    views train), its student initialised apart from the teacher, as the
    JAX package's own step tests do, so that the loss is far above bf16's
    rounding: f32 on the card (TF32 off) against the CPU, then bf16 on the
    card against that f32 step, at phase 6's limits. The warm-started
    student's bf16 loss against f32 is recorded beside it: its loss (the
    distance of the noisy view from the clean one, ~3e-3) is of the order
    of the squared bf16 rounding of the representations, so its relative
    difference measures that floor, not the step."""
    from wavjepa_tpu_torch.models.denoiser import DenoiserConfig, DenoiserStudent, student_from_jepa
    from wavjepa_tpu_torch.ops.audio import instance_normalize
    from wavjepa_tpu_torch.train.denoise_loop import load_teacher
    from wavjepa_tpu_torch.train.denoise_step import (
        DenoiseOptimizerConfig,
        DenoiseTrainState,
        make_denoise_optimizer,
        make_denoise_train_step,
    )

    cfg = denoise_config(os.path.join(DENOISE_DIR, "parity"), "trainer.precision=f32")
    f32_cfg = cfg.build_denoise_model_config()
    opt_cfg = DenoiseOptimizerConfig(warmup_steps=1)  # step 1: lr = the peak, 1e-4
    rng = np.random.default_rng(12)
    clean = rng.standard_normal((2, 1, f32_cfg.target_length)).astype(np.float32)
    noisy = clean + 0.5 * rng.standard_normal(clean.shape).astype(np.float32)
    crops = [instance_normalize(torch.from_numpy(x)) for x in (clean, noisy)]

    def one_step(model_cfg, device, warm=False):
        teacher = load_teacher("", model_cfg, DENOISE_TEACHER_SEED, device)
        if warm:
            student = student_from_jepa(teacher)
        else:
            student = DenoiserStudent(model_cfg)
            student.init_parameters(torch.Generator().manual_seed(DENOISE_TEACHER_SEED + 1))
            student.to(device)
        state = DenoiseTrainState(student, make_denoise_optimizer(opt_cfg, student))
        state.step = 1
        step = make_denoise_train_step(opt_cfg, DenoiserConfig(jepa=model_cfg, alpha=0.3),
                                       with_rir=True, with_noise=True)
        state, m = step.step_on(state, teacher, *(c.to(device, model_cfg.dtype) for c in crops))
        weights = {k: v.detach().float().cpu() for k, v in state.student.state_dict().items()}
        return float(m["loss"]), float(m["grad_norm"]), m["lr"], weights

    bf16_cfg = dataclasses.replace(f32_cfg, dtype=torch.bfloat16)
    card = one_step(f32_cfg, "cuda")
    cpu = one_step(f32_cfg, "cpu")
    lr = card[2]
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    gn_rel = abs(card[1] - cpu[1]) / abs(cpu[1])
    w_err = max((card[3][k] - cpu[3][k]).abs().max().item() for k in cpu[3])
    if not (loss_rel <= STEP_LOSS_REL and gn_rel <= STEP_GRAD_NORM_REL
            and w_err <= STEP_PARAM_ATOL_LR * lr):
        raise AssertionError(f"f32 denoise step, card vs CPU: loss rel {loss_rel}, grad_norm "
                             f"rel {gn_rel}, weights {w_err} (lr {lr})")
    bf16 = one_step(bf16_cfg, "cuda")
    bf16_rel = abs(bf16[0] - card[0]) / abs(card[0])
    if not bf16_rel <= STEP_BF16_LOSS_REL:
        raise AssertionError(f"bf16 denoise step vs f32 step on the card: loss rel {bf16_rel}")
    warm32, warm16 = one_step(f32_cfg, "cuda", warm=True), one_step(bf16_cfg, "cuda", warm=True)
    warm_rel = abs(warm16[0] - warm32[0]) / abs(warm32[0])
    print(f"[denoise parity] f32 step card vs CPU: loss {card[0]:.6f} vs {cpu[0]:.6f} (rel "
          f"{loss_rel:.3g}, limit {STEP_LOSS_REL}), grad_norm rel {gn_rel:.3g} (limit "
          f"{STEP_GRAD_NORM_REL}), weights max abs {w_err:.3g} (limit "
          f"{STEP_PARAM_ATOL_LR * lr:.3g}); bf16 step loss {bf16[0]:.6f}, rel {bf16_rel:.3g} "
          f"(limit {STEP_BF16_LOSS_REL}); warm-started student: f32 loss {warm32[0]:.6g}, "
          f"bf16 {warm16[0]:.6g} (rel {warm_rel:.3g}, recorded)", flush=True)
    return {"loss_card": card[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
            "grad_norm_card": card[1], "grad_norm_cpu": cpu[1], "grad_norm_rel": gn_rel,
            "weights_max_abs_err": w_err, "lr": lr, "bf16_loss": bf16[0],
            "bf16_loss_rel": bf16_rel, "warm_f32_loss": warm32[0], "warm_bf16_loss": warm16[0],
            "warm_bf16_loss_rel": warm_rel}


def phase_denoise_trace(teacher_path: str) -> dict:
    """One denoise step at the CLI's defaults (synthetic scene batch) under
    torch.profiler after warm-up steps (``build/chip_smoke_trace/``): its
    wall time untraced and traced, the card's busy and idle share, the
    kernels it launched and their time by class, and the scene build's
    share of the card's kernel time."""
    from wavjepa_tpu_torch.train.denoise_loop import build_denoise_data_iterator, build_denoise_run
    from wavjepa_tpu_torch.train.loop import step_seed
    from wavjepa_tpu_torch.utils import profiling

    cfg = denoise_config(os.path.join(DENOISE_DIR, "trace"), "data.synthetic=true",
                         f"teacher_ckpt={teacher_path}")
    dev, _, state, step_fn = build_denoise_run(cfg, "cuda")
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(build_denoise_data_iterator(cfg)).items()}
    generator = torch.Generator(device=dev)
    untraced = []
    for _ in range(TRACE_WARMUP + 1):
        t0 = time.perf_counter()
        generator.manual_seed(step_seed(cfg.trainer.seed, state.step))
        state, m = step_fn(state, batch, generator)
        float(m["loss"])
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with profiling.trace(TRACE_DIR, name="denoise_step"):
        with torch.profiler.record_function("train_step"):
            generator.manual_seed(step_seed(cfg.trainer.seed, state.step))
            state, m = step_fn(state, batch, generator)
            loss = float(m["loss"])
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(TRACE_DIR, "denoise_step.json.gz")
    summary = profiling.trace_summary(path, window="train_step", top=10)
    scenes = profiling.trace_summary(path, window="scene_synthesis", top=3)
    if not summary["kernels"] or not np.isfinite(loss):
        raise AssertionError(f"denoise trace: {summary['kernels']} kernels, loss {loss}")
    a = cfg.resolved_denoise_accum_steps()
    rec = {"accum_steps": a, "loss": loss, "untraced_ms": untraced[-1],
           "traced_wall_ms": traced_ms, **summary,
           "kernels_per_microbatch": summary["kernels"] / a,
           "scene_synthesis_host_us": scenes["wall_us"], "trace_file": path}
    print(f"[denoise trace] ({a} microbatches): step {untraced[-1]:.1f} ms untraced, "
          f"{traced_ms:.1f} ms traced (window {summary['wall_us'] / 1e3:.1f} ms); card busy "
          f"{summary['busy_us'] / 1e3:.1f} ms, idle share {summary['idle_share']:.3f}; kernels "
          f"{summary['kernels']} ({rec['kernels_per_microbatch']:.0f} a microbatch), summed "
          f"{summary['kernel_us'] / 1e3:.1f} ms; by class: " + ", ".join(
              f"{cls} {us / 1e3:.1f} ms" for cls, us in summary["kernel_us_by_class"].items()),
          flush=True)
    for kname, n, us in summary["top_kernels"]:
        print(f"[denoise trace] kernel {us / 1e3:8.2f} ms {n:6d}x  {kname[:110]}")
    del state, step_fn, batch
    torch.cuda.empty_cache()
    return rec


def phase_denoise(counters: dict, shards: tuple) -> dict:
    """Phase 10, denoise distillation at the CLI's defaults (base width,
    bf16): a seeded JEPA written as a port checkpoint and loaded as the
    teacher; train_denoiser on synthetic scene batches at α = 0 and α =
    0.5; one f32 step card against CPU and bf16 against it; train_denoiser
    from ``shards`` (phase 9's, deleted after) with device banks and one
    refresh a batch; the CLI (its ``main`` in this process); the distilled
    student served."""
    import shutil

    from wavjepa_tpu_torch.ops.flash_attention import flash_attention_bwd_route

    shutil.rmtree(DENOISE_DIR, ignore_errors=True)
    teacher_path, teacher_sd = write_denoise_teacher(os.path.join(DENOISE_DIR, "teacher"))
    model_cfg = denoise_config(DENOISE_DIR).build_denoise_model_config()
    t = model_cfg.total_patches
    route = flash_attention_bwd_route(t, model_cfg.encoder_dim // model_cfg.encoder_heads,
                                      torch.bfloat16)
    if route != "two_pass":
        raise AssertionError(f"the denoiser's backward at T = {t} takes route {route}")
    layers = model_cfg.encoder_layers
    # a microbatch: the teacher, the clean and the noisy student forward; the
    # noisy student's backward (α = 0) or both students' (0 < α < 1)
    alpha_0 = dict(zip(counters, (3 * layers, layers, 0, 0)))
    blend = dict(zip(counters, (3 * layers, 2 * layers, 0, 0)))
    record = {"teacher": teacher_path, "bwd_route": route, "tokens": t}
    record["train"] = phase_denoise_train(counters, teacher_path, teacher_sd, [
        ("denoise", [], DENOISE_STEPS, alpha_0, True),
        ("denoise_alpha_0.5", ["alpha=0.5"], DENOISE_STEPS_BLEND, blend, False)])
    record["trace"] = phase_denoise_trace(teacher_path)
    record["parity"] = phase_denoise_parity()
    record["train_shards"] = phase_denoise_train(counters, teacher_path, teacher_sd, [
        ("denoise_shards", [], DENOISE_STEPS, alpha_0, False)], shards=shards)
    shutil.rmtree(NAT_SHARDS_DIR)
    run, shard_run = record["train"]["denoise"], record["train_shards"]["denoise_shards"]
    print(f"[denoise] from shards with device banks beside synthetic scenes: step p50 "
          f"{shard_run['step_p50_ms']:.1f} vs {run['step_p50_ms']:.1f} ms, "
          f"{shard_run['clips_per_s']:.2f} vs {run['clips_per_s']:.2f} clips/s; data wait "
          f"p50 {shard_run['data_wait_p50_ms']:.2f} ms a step (each step's: "
          f"{', '.join(f'{x:.1f}' for x in shard_run['data_wait_ms'])})", flush=True)

    # the CLI: python -m wavjepa_tpu_torch.denoise, its main in this process
    torch.cuda.empty_cache()
    cli_dir = os.path.join(DENOISE_DIR, "cli")
    argv = ["data.synthetic=true", f"teacher_ckpt={teacher_path}", f"trainer.steps={CLI_STEPS}",
            "trainer.log_every=1", "optimizer.warmup_steps=2", f"trainer.save_dir={cli_dir}"]
    rc, stdout, cli_s = cli_in_process("wavjepa_tpu_torch.denoise", argv)
    ckpts = [os.path.join(d, f) for d, _, fs in os.walk(cli_dir) for f in fs
             if f == f"step_{CLI_STEPS:08d}.ckpt"]
    losses = [float(line.split("loss=")[1].split()[0]) for line in stdout.splitlines()
              if line.startswith("[step ")]
    if (rc != 0 or "run: Denoise-" not in stdout or not ckpts
            or len(losses) != CLI_STEPS or not all(np.isfinite(losses))):
        raise AssertionError(f"denoise CLI: exit {rc}, checkpoints {ckpts}, "
                             f"losses {losses}\n{stdout[-3000:]}")
    record["cli"] = {"argv": argv, "seconds": cli_s, "losses": losses}
    print(f"[denoise] CLI: {CLI_STEPS} steps, losses {', '.join(f'{x:.5f}' for x in losses)}, "
          f"checkpoint written; {cli_s:.1f} s", flush=True)
    shutil.rmtree(DENOISE_DIR)
    return record


def timed_requests(tag: str, counters: dict, requests: list, layers: int) -> dict:
    """Each request (name, call, expected embeddings shape, samples of its
    longest clip or None for a scene request) once with its checks, then
    timed: the flash forward once per encoder layer a call and no other
    counted kernel; finite f32 embeddings of the expected shape; timestamps
    on the runtime's uniform grid. The counts are set to 0 just before the
    requests and read just after them."""
    fwd = counters["flash_attention_fwd"]
    for c in counters.values():  # the main path's run starts here
        c.launches = 0
    record, reps = {}, 12
    for name, call, expect, n in requests:
        before = fwd.launches
        emb, ts = call()
        torch.cuda.synchronize()
        if fwd.launches - before != layers:
            raise AssertionError(f"{tag} {name}: {fwd.launches - before} flash forwards, "
                                 f"expected {layers}")
        if tuple(emb.shape) != expect or emb.dtype != torch.float32 or not torch.isfinite(emb).all():
            raise AssertionError(f"{tag} {name}: embeddings {tuple(emb.shape)} {emb.dtype}, "
                                 f"expected {expect}, or not finite")
        rec = {"shape": list(emb.shape)}
        if ts is not None:
            step = n / 16000 / expect[1] * 1000.0
            if tuple(ts.shape) != expect[:2] or ts[0, 0].item() != 0.0 or \
                    abs(ts[0, 1].item() - step) > 1e-9:
                raise AssertionError(f"{tag} {name}: timestamps {tuple(ts.shape)} not a "
                                     f"{step}-ms grid")
            rec["step_ms"] = step
        times = []
        for i in range(reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            if i >= 2:  # two warm-up requests
                times.append((time.perf_counter() - t0) * 1e3)
        rec.update(p50_ms=statistics.median(times), n=len(times))
        record[name] = rec
        print(f"[{tag}] {name}: out {tuple(emb.shape)}"
              + (f", {rec['step_ms']:.4f}-ms steps" if ts is not None else "")
              + f", p50 {rec['p50_ms']:.3f} ms over {len(times)} requests", flush=True)
    launches = {k: c.launches for k, c in counters.items()}  # read just after
    expected = dict.fromkeys(counters, 0)
    expected["flash_attention_fwd"] = layers * (reps + 1) * len(requests)
    if launches != expected:
        raise AssertionError(f"{tag}: launches {launches}, expected {expected}")
    record["launches"] = launches
    return record


def phase_eval_hf(counters: dict, ckpt: str) -> dict:
    """The HF-style surface at base width: the feature extractor on a 10-s
    clip at 44.1 kHz and at 16 kHz into ``WavJEPAForAudioEmbeddings`` of
    phase 5's checkpoint, and a 2-channel WavJEPA-Nat request (seeded
    weights); then its embeddings against ``load_model``'s on the same
    checkpoint, bit for bit."""
    from wavjepa_tpu_torch.api.hf import WavJEPAFeatureExtractor, WavJEPAForAudioEmbeddings
    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model

    model = WavJEPAForAudioEmbeddings.from_pretrained(ckpt)  # its model_config.json
    nat = WavJEPAForAudioEmbeddings.from_pretrained("", in_channels=2, channel_wise=True)
    rng = np.random.default_rng(51)
    clip_44k = (0.1 * rng.standard_normal(441000)).astype(np.float32)
    clip_16k = (0.1 * rng.standard_normal(160000)).astype(np.float32)
    binaural = (0.1 * rng.standard_normal((1, 2, 160000))).astype(np.float32)
    fx = WavJEPAFeatureExtractor()
    from_44k = fx(clip_44k, sampling_rate=44100)
    extract_ms = median_ms(lambda: fx(clip_44k, sampling_rate=44100), 5)
    inputs = {"hf_44k1_10s": from_44k, "hf_16k_10s": fx(clip_16k, sampling_rate=16000),
              "hf_nat_10s": WavJEPAFeatureExtractor(in_channels=2)(binaural)}
    if from_44k.shape != (1, 1, 160000) or inputs["hf_nat_10s"].shape != (1, 2, 160000):
        raise AssertionError(f"feature extractor: {from_44k.shape}, "
                             f"{inputs['hf_nat_10s'].shape}")
    _, _, rows, _ = chunk_padding(160000, model.runtime.unit_frames, 16000,
                                  model.runtime.output_steps)
    width = model.runtime.embedding_size
    requests = [(name, (lambda m=m, x=inputs[name]: m(x)), (1, rows, width), 160000)
                for name, m in (("hf_44k1_10s", model), ("hf_16k_10s", model),
                                ("hf_nat_10s", nat))]
    record = timed_requests("eval hf", counters, requests, model.config.encoder_layers)
    record["extract_44k1_ms"] = extract_ms
    # the same checkpoint through load_model: the same bits
    runtime = load_model(ckpt)
    for name in ("hf_44k1_10s", "hf_16k_10s"):
        emb, ts = model(inputs[name])
        ref_emb, ref_ts = runtime.get_timestamp_embeddings(inputs[name])
        if not (torch.equal(emb, ref_emb) and torch.equal(ts, ref_ts)):
            raise AssertionError(f"{name}: HF embeddings differ from load_model's "
                                 f"(max {(emb - ref_emb).abs().max().item()})")
    record["bitwise_equal_to_load_model"] = True
    if model.config.dtype != torch.bfloat16 or model.config.pack_encoder is not None:
        raise AssertionError(f"the checkpoint's sidecar not read: {model.config}")
    print(f"[eval hf] phase 5's checkpoint: embeddings equal load_model's bit for bit; the "
          f"extractor took {extract_ms:.1f} ms for 10 s at 44.1 kHz", flush=True)
    return record


def phase_eval_w2v2(counters: dict) -> dict:
    """``api/hear_wavjepa_w2v2`` at base width with seeded weights: scene
    embeddings of 8 clips of 10 s, timestamps of a ragged batch (1.0, 4.02,
    4.3, 30 s) and of one clip of exactly one window (64319 samples, int(16000
    · 4.02), which gains a whole padding window); 200 tokens a window and
    20-ms steps; f32 on the card against the CPU, bf16 against f32."""
    from wavjepa_tpu_torch.api import hear_wavjepa_w2v2 as w2v2
    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model

    rt = w2v2.load_model("", seed=0)
    if (rt.output_steps, rt.unit_frames) != (200, 64319):
        raise AssertionError(f"w2v2 window: {rt.unit_frames} samples, {rt.output_steps} tokens")
    requests = []
    for name, kind, clips in (("w2v2_scene_8x10s", "scene", make_clips([10.0] * 8, 61)),
                              ("w2v2_timestamps_ragged", "timestamps",
                               make_clips([1.0, 4.02, 4.3, 30.0], 62)),
                              ("w2v2_timestamps_exact_window", "timestamps",
                               make_clips([rt.unit_frames / 16000], 63))):
        n = max(len(c) for c in clips)
        _, _, rows, _ = chunk_padding(n, rt.unit_frames, 16000, rt.output_steps)
        width = rt.embedding_size
        expect = (len(clips), width) if kind == "scene" else (len(clips), rows, width)
        requests.append((name, (lambda k=kind, c=clips: serve_request(rt, k, c)), expect,
                         None if kind == "scene" else n))
    record = timed_requests("eval w2v2", counters, requests, rt.config.encoder_layers)
    for name in ("w2v2_timestamps_ragged", "w2v2_timestamps_exact_window"):
        step = record[name]["step_ms"]
        if not abs(step - W2V2_STEP_MS) <= W2V2_STEP_REL * W2V2_STEP_MS:
            raise AssertionError(f"{name}: {step}-ms steps, not 20 ms")

    cfg = dataclasses.replace(w2v2.w2v2_config("base"), dtype=torch.float32)
    clips = make_clips([4.02, 1.0], 64)
    e_card = load_model("", config=cfg, device="cuda", seed=0).get_timestamp_embeddings(clips)[0].cpu()
    e_cpu = load_model("", config=cfg, device="cpu", seed=0).get_timestamp_embeddings(clips)[0]
    err = (e_card - e_cpu).abs().max().item()
    if not torch.allclose(e_card, e_cpu, atol=CARD_CPU_ATOL, rtol=CARD_CPU_ATOL):
        raise AssertionError(f"w2v2 f32 card vs CPU: max abs err {err}")
    e_bf16 = rt.get_timestamp_embeddings(clips)[0].cpu()
    rel = (torch.linalg.norm(e_bf16 - e_card) / torch.linalg.norm(e_card)).item()
    if not rel <= BF16_REL_FRO:
        raise AssertionError(f"w2v2 bf16 vs f32: relative Frobenius {rel}")
    record["parity"] = {"f32_card_vs_cpu_max_abs_err": err, "bf16_vs_f32_rel_fro": rel,
                        "shape": list(e_card.shape)}
    print(f"[eval w2v2] f32 card vs CPU max abs err {err:.3g} (atol {CARD_CPU_ATOL}); bf16 vs "
          f"f32 relative Frobenius {rel:.4g} (limit {BF16_REL_FRO}), {tuple(e_card.shape)}",
          flush=True)
    return record


def phase_eval_harness(counters: dict) -> dict:
    """The HEAR harness on the card, at the size of two public HEAR tasks
    (synthetic audio, ``eval/synthetic.py``): ESC-50's 2000 clips of 5 s in
    5 folds and DCASE 2016 task 2's clips of 120 s, a third of its 72
    (``HEAR_EVENT_SPLITS``). The port's embeddings
    runner in-process with ``api/hear_wavjepa`` at base width (seeded
    weights), then ``predictions --grid faster`` with the probes on the
    card; the on-disk contract, finite scores in range, the probes'
    parameters on ``cuda``; clips/s, audio-s/s, peak memory, probe ms an
    epoch; then both CLIs (their ``main`` in this process) on the port's
    test-size tones task. Accuracy is
    printed, not gated: the weights are random."""
    import math
    import pickle
    import shutil

    from wavjepa_tpu_torch.eval import embeddings, predictions, synthetic
    from wavjepa_tpu_torch.eval.score import available_scores, label_vocab_as_dict, read_label_vocab
    from wavjepa_tpu_torch.models.jepa import JEPAConfig

    base = JEPAConfig()  # api/hear_wavjepa's model without a checkpoint
    shutil.rmtree(HEAR_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    task_dirs = [synthetic.write_scene_task(HEAR_DIR, 16000, **synthetic.ESC50_LAYOUT),
                 synthetic.write_event_task(HEAR_DIR, 16000, **dict(
                     synthetic.DCASE2016_TASK2_LAYOUT, splits=HEAR_EVENT_SPLITS))]
    write_s = time.perf_counter() - t0
    files = {t.name: synthetic.split_files(t) for t in task_dirs}
    print(f"[eval tasks] {', '.join(f'{t}: {sum(n.values())} clips' for t, n in files.items())}"
          f" written in {write_s:.1f} s", flush=True)
    tasks, emb_root = os.path.join(HEAR_DIR, "tasks"), os.path.join(HEAR_DIR, "embeddings")
    module = "wavjepa_tpu_torch.api.hear_wavjepa"
    calls = 0
    for t in task_dirs:
        with open(t / "task_metadata.json") as f:
            bs = embeddings.estimated_batch_size(json.load(f), 16000)
        calls += sum(math.ceil(n / bs) for n in files[t.name].values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():  # the main path's run starts here
        c.launches = 0
    t0 = time.perf_counter()
    dirs = embeddings.runner(module, tasks_dir=tasks, embeddings_dir=emb_root)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}  # read just after
    expected = dict.fromkeys(counters, 0)
    expected["flash_attention_fwd"] = base.encoder_layers * calls
    if launches != expected:
        raise AssertionError(f"eval embeddings: launches {launches}, expected {expected} "
                             f"({calls} module calls)")
    record = {"launches": launches, "module_calls": calls, "wall_s": wall_s,
              "tasks_written_s": write_s, "tasks": {}}
    for d in dirs:
        task = os.path.basename(d)
        with open(os.path.join(d, "task_metadata.json")) as f:
            metadata = json.load(f)
        with open(os.path.join(d, "profile.embeddings.json")) as f:
            profile = json.load(f)
        n_clips = sum(files[task].values())
        seconds = n_clips * metadata["sample_duration"]
        for split in metadata["splits"]:
            with open(os.path.join(d, f"{split}.embedding-dimensions.json")) as f:
                dims = json.load(f)
            x = np.memmap(os.path.join(d, f"{split}.embeddings.npy"), np.float32, "r",
                          shape=tuple(dims))
            with open(os.path.join(d, f"{split}.target-labels.pkl"), "rb") as f:
                labels = pickle.load(f)
            rows = files[task][split] if metadata["embedding_type"] == "scene" else len(labels)
            if dims[1] != base.encoder_dim or dims[0] != rows or len(labels) != rows or \
                    not np.isfinite(x).all():
                raise AssertionError(f"{task} {split}: embeddings {dims}, {len(labels)} labels")
            extra = (["filename-timestamps.json"] if metadata["embedding_type"] == "event"
                     else [])
            for name in [f"{split}.json", *[f"{split}.{e}" for e in extra]]:
                if not os.path.isfile(os.path.join(d, name)):
                    raise AssertionError(f"{task}: no {name}")
        for name in ("task_metadata.json", "labelvocabulary.csv", ".done.embeddings"):
            if not os.path.isfile(os.path.join(d, name)):
                raise AssertionError(f"{task}: no {name}")
        record["tasks"][task] = {
            "clips": n_clips, "audio_s": seconds, "time_s": profile["time_s"],
            "clips_per_s": n_clips / profile["time_s"],
            "audio_s_per_s": seconds / profile["time_s"],
            "device_max_mem_mb": profile["device_max_mem_mb"]}
        print(f"[eval embeddings] {task}: {n_clips} clips, {seconds:.0f} s of audio in "
              f"{profile['time_s']:.2f} s: {n_clips / profile['time_s']:.1f} clips/s, "
              f"{seconds / profile['time_s']:.1f} audio-s/s; peak memory "
              f"{profile['device_max_mem_mb']:.0f} MiB", flush=True)
    print(f"[eval embeddings] {calls} module calls, {launches['flash_attention_fwd']} flash "
          f"forwards ({base.encoder_layers} a call); {wall_s:.2f} s with the model's load",
          flush=True)

    # the probes on the card
    devices = set()
    forward = predictions.FullyConnectedProbe.forward

    def seen_forward(self, x, generator=None):
        devices.add((next(self.parameters()).device.type, x.device.type))
        return forward(self, x, generator)

    predictions.FullyConnectedProbe.forward = seen_forward
    results, grid_points = {}, {}
    try:
        t0 = time.perf_counter()
        for d in dirs:
            with open(os.path.join(d, "task_metadata.json")) as f:
                points = HEAR_GRID_POINTS[json.load(f)["embedding_type"]]
            grid_points[os.path.basename(d)] = points
            results.update(predictions.runner([str(d)], grid_points=points, grid="faster"))
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
    finally:
        predictions.FullyConnectedProbe.forward = forward
    if devices != {("cuda", "cuda")}:
        raise AssertionError(f"probes ran on {devices}")
    scores, task_pred_s = {}, {}
    for d, res in results.items():
        task = os.path.basename(d)
        for name in ("test.predicted-scores.json", "prediction-done.json"):
            if not os.path.isfile(os.path.join(d, name)):
                raise AssertionError(f"{task}: no {name}")
        with open(os.path.join(d, "prediction-done.json")) as f:
            task_pred_s[task] = json.load(f)["time_s"]
        # a test split's scores, or each fold's and their mean and deviation
        folds = {k: v for k, v in res.items()
                 if isinstance(v, dict) and any(n.startswith("test_") for n in v)}
        for fold, values in folds.items():
            for k, v in values.items():
                if not k.startswith("test_"):
                    continue
                # an error rate (and "test_score", the last tuple score's
                # first value: here segment_1s_er's) has no upper bound, nor
                # has the mean or deviation of one over the folds
                name = k.removesuffix("_mean").removesuffix("_std")
                low, high = (0.0, math.inf) if name.endswith(("error_rate", "_score")) \
                    else (0.0, 1.0)
                if not (np.isfinite(v) and low <= v <= high):
                    raise AssertionError(f"{task} {fold}: {k} = {v}")
        top = res.get("aggregated_scores", res.get("test"))
        scores[task] = {k: v for k, v in top.items() if k.startswith("test_")}
    record.update(predictions_s=pred_s, predictions_task_s=task_pred_s, grid_points=grid_points,
                  scores=scores, probe_devices=sorted(devices))
    print(f"[eval predictions] --grid faster, probes on the card: {pred_s:.1f} s ("
          f"{', '.join(f'{t} {v:.1f} s at {grid_points[t]} grid points' for t, v in task_pred_s.items())}"
          f"); scores (random weights, not gated): {scores}", flush=True)

    # probe ms an epoch on the first split's train rows, training alone (no
    # validation), hidden 128: the time of 2n epochs less that of n, over n
    # (n = 5, or 2 above 100k rows), so that loading the split and building
    # the probe fall out
    conf = dict(hidden_layers=1, hidden_dim=128, dropout=0.1, lr=1e-3, patience=1,
                max_epochs=10, check_val_every_n_epoch=100, batch_size=1024,
                initialization="xavier_uniform")
    record["probe"] = {}
    for d in dirs:
        task = os.path.basename(d)
        with open(os.path.join(d, "task_metadata.json")) as f:
            metadata = json.load(f)
        label_to_idx = label_vocab_as_dict(
            read_label_vocab(os.path.join(d, "labelvocabulary.csv")), "label", "idx")
        score_fns = [available_scores[s](label_to_idx=label_to_idx)
                     for s in metadata["evaluation"]]
        split = predictions.get_splits_from_metadata(metadata)[0]
        rows = 0
        for name in split["train"]:
            with open(os.path.join(d, f"{name}.embedding-dimensions.json")) as f:
                rows += json.load(f)[0]
        args = (d, base.encoder_dim, metadata, split, label_to_idx, len(label_to_idx),
                score_fns)
        n = 2 if rows > 100_000 else 5  # the probes above warmed the card up
        run_s = {}
        for epochs in (n, 2 * n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictions.task_predictions_train(*args, dict(conf, max_epochs=epochs))
            torch.cuda.synchronize()
            run_s[epochs] = time.perf_counter() - t0
        ms = (run_s[2 * n] - run_s[n]) * 1e3 / n
        record["probe"][task] = {"ms_per_epoch": ms, "rows": rows, "epochs_timed": n,
                                 f"run_{n}_epochs_s": run_s[n],
                                 "steps_per_epoch": math.ceil(rows / conf["batch_size"])}
        print(f"[eval probe] {task}: {ms:.2f} ms an epoch of {rows} rows "
              f"({math.ceil(rows / conf['batch_size'])} steps of 1024, hidden 128); {n} "
              f"epochs with the split's load {run_s[n] * 1e3:.1f} ms", flush=True)

    # both CLIs (their main, in this process) on the tests' small tones task
    cli_root = os.path.join(HEAR_DIR, "cli")
    synthetic.write_scene_task(cli_root, 16000)
    argvs = [["embeddings", module, "--tasks-dir", os.path.join(cli_root, "tasks"),
              "--embeddings-dir", cli_root],
             ["predictions", os.path.join(cli_root, module, "tones"), "--grid", "faster",
              "--grid-points", "2"]]
    record["cli"] = []
    for argv in argvs:
        rc, stdout, cli_s = cli_in_process("wavjepa_tpu_torch.eval", argv)
        if rc != 0 or ("test_top1_acc" not in stdout and argv[0] != "embeddings"):
            raise AssertionError(f"wavjepa_tpu_torch.eval {argv[0]}: exit {rc}\n"
                                 f"{stdout[-3000:]}")
        record["cli"].append({"argv": argv, "seconds": cli_s})
        print(f"[eval cli] wavjepa_tpu_torch.eval {argv[0]} (its main in this process): exit 0 "
              f"in {cli_s:.1f} s; {stdout.strip().splitlines()[-1][:200]}", flush=True)
    if not os.path.isfile(os.path.join(cli_root, module, "tones", "test.predicted-scores.json")):
        raise AssertionError("the CLIs wrote no test.predicted-scores.json")
    shutil.rmtree(HEAR_DIR)
    return record


def phase_eval(counters: dict) -> dict:
    """Phase 11: the HF surface on phase 5's checkpoint, the w2v2 HEAR
    module, and the HEAR harness, each path with its launch counts."""
    import shutil

    ckpt = os.path.join(EVAL_DIR, f"step_{TRAIN_STEPS:08d}.ckpt")
    record = {"hf": phase_eval_hf(counters, ckpt)}
    shutil.rmtree(EVAL_DIR)  # ~1.7 GB
    record["w2v2"] = phase_eval_w2v2(counters)
    record["harness"] = phase_eval_harness(counters)
    return record


def phase_arch(counters: dict) -> dict:
    """The ARCH recipe on ESC-50 at its size: every mode over the 5 folds,
    each mode's launches counted from 0 just before its run and read just
    after it; then the CLI (its ``main`` in this process) on a 48-clip
    layout."""
    import math
    import shutil

    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model
    from wavjepa_tpu_torch.eval.arch import ESC50, WavJEPAModel, datasets, probes
    from wavjepa_tpu_torch.eval.synthetic import write_arch_esc50

    shutil.rmtree(ARCH_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    root = str(write_arch_esc50(os.path.join(ARCH_DIR, "esc50")))
    write_s = time.perf_counter() - t0
    model = WavJEPAModel(load_model("", seed=0))
    rt = model.runtime
    recipe = ESC50(root)
    n_clips = len(recipe._all_audio_paths())
    if (n_clips, recipe.num_classes, len(recipe.folds)) != (2000, 50, 5):
        raise AssertionError(f"ESC-50 layout: {n_clips} clips, {recipe.num_classes} classes, "
                             f"{len(recipe.folds)} folds")
    print(f"[arch] ESC-50 layout: {n_clips} clips of 5 s at 44.1 kHz, 50 classes, 5 folds, "
          f"written in {write_s:.1f} s", flush=True)
    _, _, tokens, _ = chunk_padding(80000, rt.unit_frames, rt.sample_rate, rt.output_steps)
    acc = {}
    load, embed, train = datasets.load_clip, model.get_batch_embeddings, \
        probes.ClassificationProbe.train

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t
            acc[key + "_n"] += 1
            return out
        return wrapper

    datasets.load_clip = timed("load", load)
    model.get_batch_embeddings = timed("embed", embed)
    probes.ClassificationProbe.train = timed("probe", train)
    record = {"clips": n_clips, "write_s": write_s, "tokens_per_clip": tokens, "modes": {}}
    try:
        for mode, epochs in ARCH_EPOCHS.items():
            acc.update(dict.fromkeys(("load", "load_n", "embed", "embed_n", "probe",
                                      "probe_n"), 0))
            for c in counters.values():  # the main path's run starts here
                c.launches = 0
            t0 = time.perf_counter()
            results = recipe.evaluate(model, mode=mode, max_num_epochs=epochs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}  # read just after
            expected = dict.fromkeys(counters, 0)
            expected["flash_attention_fwd"] = rt.config.encoder_layers * acc["embed_n"]
            if launches != expected:
                raise AssertionError(f"arch {mode}: launches {launches}, expected {expected}")
            kind = "token" if mode == "attention-pooling" else "clip"
            embs = [v for (_, k), v in recipe._embedding_cache.items() if k == kind]
            shape = (tokens, rt.embedding_size) if kind == "token" else (rt.embedding_size,)
            if len(embs) != n_clips or any(e.shape != shape or not np.isfinite(e).all()
                                           for e in embs):
                raise AssertionError(f"arch {mode}: {len(embs)} {kind} embeddings, not "
                                     f"{n_clips} finite ones of {shape}")
            for k, v in results.items():
                high = math.inf if k.startswith("loss") or k.endswith("_std") else 1.0
                if not (np.isfinite(v) and 0.0 <= v <= high):
                    raise AssertionError(f"arch {mode}: {k} = {v}")
            embedded = acc["load_n"]
            rec = {"results": results, "launches": launches, "wall_s": wall,
                   "embed_calls": acc["embed_n"], "clips_embedded": embedded,
                   "decode_resample_s": acc["load"], "embed_s": acc["embed"],
                   "probe_s": acc["probe"], "epochs": epochs, "folds": acc["probe_n"],
                   "probe_ms_per_epoch": acc["probe"] * 1e3 / (epochs * acc["probe_n"])}
            if embedded:
                host_s = acc["load"] + acc["embed"]
                rec.update(clips_per_s=embedded / host_s,
                           audio_s_per_s=embedded * 5.0 / host_s,
                           decode_resample_share=acc["load"] / host_s)
                print(f"[arch {mode}] embeddings: {embedded} clips in {host_s:.2f} s "
                      f"({rec['clips_per_s']:.1f} clips/s, {rec['audio_s_per_s']:.1f} "
                      f"audio-s/s); decode + resample {acc['load']:.2f} s, "
                      f"{rec['decode_resample_share']:.3f} of it; {acc['embed_n']} calls, "
                      f"{launches['flash_attention_fwd']} flash forwards", flush=True)
            print(f"[arch {mode}] probe {rec['probe_ms_per_epoch']:.1f} ms an epoch "
                  f"({epochs} epochs x {acc['probe_n']} folds, {acc['probe']:.2f} s); fold "
                  f"mean (random weights, not gated): accuracy "
                  f"{results['accuracy']:.4f} ± {results['accuracy_std']:.4f}, f1 "
                  f"{results['f1']:.4f}; {wall:.1f} s", flush=True)
            record["modes"][mode] = rec
    finally:
        datasets.load_clip, probes.ClassificationProbe.train = load, train
    del recipe, model
    torch.cuda.empty_cache()

    # the CLI (its main, in this process): 12 classes x 4 clips
    cli_root = os.path.join(ARCH_DIR, "cli")
    write_arch_esc50(os.path.join(cli_root, "esc50"), classes=12, clips_per_class=4, folds=2,
                     seconds=2.0)
    tsv = os.path.join(cli_root, "results.tsv")
    argv = ["--data-dir", cli_root, "--datasets", "esc50", "--mode", "linear", "--max-epochs",
            "2", "--tsv", tsv]
    rc, stdout, cli_s = cli_in_process("wavjepa_tpu_torch.eval.arch", argv)
    rows = open(tsv).read().splitlines() if os.path.isfile(tsv) else []
    if rc != 0 or len(rows) != 7 or not rows[1].startswith("esc50\tlinear\t"):
        raise AssertionError(f"arch CLI: exit {rc}, {len(rows)} TSV rows\n{stdout[-3000:]}")
    record["cli"] = {"argv": argv, "seconds": cli_s, "tsv_rows": len(rows) - 1}
    print(f"[arch cli] its main in this process: exit 0 in {cli_s:.1f} s; {len(rows) - 1} TSV "
          f"rows", flush=True)
    shutil.rmtree(ARCH_DIR)
    return record


def xares_tones(n_per_class: int, classes: int, seconds: float, seed: int,
                multilabel: bool = False) -> list:
    """In-memory X-ARES samples at 16 kHz: one class's tone a clip (label
    ``class<k>``), or for ``multilabel`` one to three of ``classes`` tones
    (``labels``), each plus noise of σ 0.01."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    freqs = 100.0 * 2.0 ** (6.0 * np.arange(classes) / max(1, classes - 1))
    out = []
    for i in range(n_per_class * classes):
        ks = (sorted(rng.choice(classes, int(rng.integers(1, 4)), replace=False))
              if multilabel else [i % classes])
        wav = sum(rng.uniform(0.2, 0.5) * np.sin(2 * np.pi * freqs[k] * t + rng.uniform(0, 6.28))
                  for k in ks) + 0.01 * rng.standard_normal(t.size)
        sample = {"audio": wav.astype(np.float32)}
        sample.update({"labels": [int(k) for k in ks]} if multilabel else
                      {"label": f"class{ks[0]:02d}"})
        out.append(sample)
    return out


def phase_xares(counters: dict) -> dict:
    """X-ARES at base width (seeded weights): the contract check, the timed
    request, the stub task and the vendored protocol on ESC-50 and FSD50K
    shapes, counted from 0 just before and read just after; the contract
    check on a ``fused_block`` runtime likewise; then the f32 encoder card
    against CPU on one batch."""
    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model
    from wavjepa_tpu_torch.eval.xares import WavJEPAEncoder, check_audio_encoder
    from wavjepa_tpu_torch.eval.xares import run as xrun
    from wavjepa_tpu_torch.eval.xares import vendored_protocol as vp
    from wavjepa_tpu_torch.models.jepa import JEPAConfig

    enc = WavJEPAEncoder()  # seeded weights (no WAVJEPA_CKPT), on the card
    fused = WavJEPAEncoder(runtime=load_model(
        "", config=JEPAConfig(attn_impl="fused_block", dtype=torch.bfloat16), seed=0))
    forwards = {}
    for name, e in (("default", enc), ("fused", fused)):
        def counted(*args, _f=e.runtime._encode, _n=name):
            forwards[_n] += 1
            return _f(*args)
        e.runtime._encode = counted
    n_esc, n_fsd = XARES_CLIPS["esc50"], XARES_CLIPS["fsd50k"]
    t0 = time.perf_counter()
    esc = {"train": xares_tones(n_esc[0] // 50, 50, 5.0, 81),
           "test": xares_tones(n_esc[1] // 50, 50, 5.0, 82)}
    fsd = {"train": xares_tones(n_fsd[0] // 20, 20, 10.0, 83, multilabel=True),
           "test": xares_tones(n_fsd[1] // 20, 20, 10.0, 84, multilabel=True)}
    data_s = time.perf_counter() - t0
    b, seconds = XARES_REQUEST
    request = torch.from_numpy(np.stack(make_clips([seconds] * b, 85)))
    _, _, frames, _ = chunk_padding(request.shape[1], enc.runtime.unit_frames,
                                    enc.sampling_rate, enc.runtime.output_steps)
    layers = enc.runtime.config.encoder_layers

    forwards.update(default=0, fused=0)
    for c in counters.values():  # the main path's run starts here
        c.launches = 0
    t0 = time.perf_counter()
    check_audio_encoder(enc)
    times = []
    for i in range(12):
        t = time.perf_counter()
        out = enc(request)
        if i >= 2:  # two warm-up requests; the output is on the host
            times.append((time.perf_counter() - t) * 1e3)
    stub = xrun.run_stub_task(enc)
    esc_result = vp.run_task_protocol(vp.config_esc50(enc), esc)
    fsd_result = vp.run_task_protocol(vp.config_fsd50k(enc), fsd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}  # read just after
    expected = dict.fromkeys(counters, 0)
    expected["flash_attention_fwd"] = layers * forwards["default"]
    if launches != expected or forwards["fused"]:
        raise AssertionError(f"xares: launches {launches}, expected {expected}")
    if tuple(out.shape) != (b, frames, enc.output_dim) or out.device.type != "cpu":
        raise AssertionError(f"xares request: {tuple(out.shape)} on {out.device}")
    for name, res, key in (("stub", stub, "value"), ("esc50", esc_result, "value"),
                           ("esc50 knn", esc_result, "knn_accuracy"),
                           ("fsd50k", fsd_result, "value")):
        if not (np.isfinite(res[key]) and 0.0 <= res[key] <= 1.0):
            raise AssertionError(f"xares {name}: {res[key]}")
    if (esc_result["n_test"], fsd_result["n_test"]) != (n_esc[1], n_fsd[1]):
        raise AssertionError(f"xares test splits: {esc_result}, {fsd_result}")
    record = {"launches": launches, "encoder_forwards": forwards["default"], "wall_s": wall,
              "data_s": data_s, "request": list(XARES_REQUEST),
              "request_p50_ms": statistics.median(times), "stub": stub, "esc50": esc_result,
              "fsd50k": fsd_result}
    print(f"[xares] contract checked; encoder request ({b}, {seconds} s) p50 "
          f"{record['request_p50_ms']:.2f} ms; stub accuracy {stub['value']:.4f}; ESC-50 "
          f"protocol ({n_esc[0]} + {n_esc[1]} clips of 5 s) accuracy {esc_result['value']:.4f}, "
          f"kNN {esc_result['knn_accuracy']:.4f}; FSD50K protocol ({n_fsd[0]} + {n_fsd[1]} "
          f"clips of 10 s) mAP {fsd_result['value']:.4f} (random weights, not gated); "
          f"{forwards['default']} encoder forwards, {launches['flash_attention_fwd']} flash "
          f"forwards in {wall:.1f} s", flush=True)

    forwards["fused"] = 0
    for c in counters.values():  # the fused path's run starts here
        c.launches = 0
    check_audio_encoder(fused)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}  # read just after
    expected = dict.fromkeys(counters, 0)
    expected["fused_attention_block_fwd"] = layers * forwards["fused"]
    if launches != expected or not forwards["fused"]:
        raise AssertionError(f"xares fused: launches {launches}, expected {expected}")
    record["fused"] = {"launches": launches, "encoder_forwards": forwards["fused"]}
    print(f"[xares fused] contract checked on a fused_block runtime: "
          f"{launches['fused_attention_block_fwd']} fused forwards, no flash", flush=True)

    # the f32 encoder on the card against the CPU, the same seed, one batch
    cfg = JEPAConfig(dtype=torch.float32)
    batch = torch.from_numpy(np.stack(make_clips([3.1, 3.1], 86)))
    e_card = WavJEPAEncoder(runtime=load_model("", config=cfg, device="cuda", seed=0))(batch)
    e_cpu = WavJEPAEncoder(runtime=load_model("", config=cfg, device="cpu", seed=0))(batch)
    err = (e_card - e_cpu).abs().max().item()
    if e_card.shape != e_cpu.shape or not torch.allclose(e_card, e_cpu, atol=CARD_CPU_ATOL,
                                                         rtol=CARD_CPU_ATOL):
        raise AssertionError(f"xares f32 encoder card vs CPU: max abs err {err}")
    record["parity"] = {"f32_card_vs_cpu_max_abs_err": err, "shape": list(e_card.shape)}
    print(f"[xares parity] f32 encoder card vs CPU max abs err {err:.3g} (atol "
          f"{CARD_CPU_ATOL}), {tuple(e_card.shape)}", flush=True)
    return record


def phase_arch_xares(counters: dict) -> dict:
    """Phase 12: the ARCH recipe and the X-ARES surfaces on the card."""
    t0 = time.perf_counter()
    record = {"arch": phase_arch(counters)}
    record["xares"] = phase_xares(counters)
    record["seconds"] = time.perf_counter() - t0
    print(f"[arch/xares] phase 12 took {record['seconds']:.1f} s", flush=True)
    return record


# phase 13 (data parallelism): (a) both CLIs under torchrun at world size 1
# over NCCL, and the gradient all-reduce alone at the base model's gradients;
# (b) two ranks on the one card over gloo (NCCL takes one rank a card),
# against one process at the same seed. The two ranks' f32 steps differ from
# the one process's only in how the crops are grouped into microbatches and
# in the all-reduce's order of sums, within phase 6's f32 limits (STEP_*,
# card against CPU through 24 layers of reordered sums); their weights must
# be equal bit for bit, every rank receiving the same sums.
PARALLEL_DIR = os.path.join("build", "chip_smoke_parallel")
# (a)'s train CLI steps (the first TRAIN_WARMUP left out of the p50), and
# (b)'s mono steps, f32 and bf16, and one Nat step; both cut from 5 and 3 for
# the script's time
TORCHRUN_STEPS = 3
PARALLEL_STEPS = 2
PARALLEL_BATCH, PARALLEL_ACCUM = 8, 2  # 16 crops a rank's microbatch, phase 5's accum-16 shapes
ALLREDUCE_REPS = 10


def launch_counters() -> dict:
    from wavjepa_tpu_torch.ops import fused_attention_block as fab
    from wavjepa_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    return dict(zip(COUNTER_NAMES, (flash_attention_fwd, flash_attention_bwd,
                                    fab.fused_attention_block_fwd,
                                    fab.fused_attention_block_bwd)))


def counted_run(counters: dict, fn) -> dict:
    """Launches of each counted wrapper in ``fn()``: set to 0 just before,
    read just after."""
    for counter in counters.values():
        counter.launches = 0
    fn()
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}


def worker_torchrun_cli(out: str, train_dir: str, denoise_dir: str) -> int:
    """Phase 13(a), one rank under torchrun: the train CLI on the AudioSet
    configuration and the denoise CLI at its defaults, as ``python -m`` runs
    them (their ``main``), each run's launches counted; then the gradient
    all-reduce of the base model timed on the run's NCCL group."""
    import torch.distributed as dist

    from wavjepa_tpu_torch import denoise as denoise_cli
    from wavjepa_tpu_torch.models.jepa import JEPA
    from wavjepa_tpu_torch.parallel.mesh import all_reduce_gradients
    from wavjepa_tpu_torch.train import __main__ as train_cli
    from wavjepa_tpu_torch.train.config import Config

    counters = launch_counters()
    record = {"launches": {}}
    common = ["data.synthetic=true", "trainer.log_every=1", "optimizer.warmup_steps=2"]
    record["launches"]["train"] = counted_run(counters, lambda: train_cli.main(
        [*common, f"trainer.steps={TORCHRUN_STEPS}", f"trainer.save_dir={train_dir}"]))
    record["launches"]["denoise"] = counted_run(counters, lambda: denoise_cli.main(
        [*common, f"trainer.steps={CLI_STEPS}", f"trainer.save_dir={denoise_dir}"]))
    record["backend"], record["world"] = dist.get_backend(), dist.get_world_size()
    record["device"] = str(torch.cuda.current_device())
    model = JEPA(Config().build_model_config()).to("cuda")
    params = list(model.parameters())
    for p in params:
        p.grad = torch.randn_like(p)
    record["allreduce_bytes"] = sum(p.numel() * p.element_size() for p in params)
    record["allreduce_ms"] = cuda_ms(lambda: all_reduce_gradients(params),
                                     iters=ALLREDUCE_REPS, warmup=2)
    with open(out, "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()
    return 0


def weights_digest(tensors: dict) -> str:
    """sha256 of a state dict's names and bytes."""
    import hashlib

    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def parallel_leg(recipe: str, items: list, steps: int) -> dict:
    """``build_run`` on the card of the defaults (or the file ``recipe``)
    with ``items``, and ``steps`` steps from the run's own synthetic data (a
    rank's rows in a process group), each step's generator seeded from
    (seed, step) as ``run_loop`` seeds it: the losses, gradient norms and
    the digests of the weights and the teacher after the steps."""
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config
    from wavjepa_tpu_torch.train.loop import (
        build_data_iterator,
        build_run,
        prefetch_to_device,
        run_step,
        step_seed,
    )

    cfg = apply_overrides(load_config(recipe), [
        "data.synthetic=true", "optimizer.warmup_steps=2", f"trainer.batch_size={PARALLEL_BATCH}",
        f"trainer.accum_steps={PARALLEL_ACCUM}", *items])
    dev, _, state, step_fn = build_run(cfg, device="cuda")
    batches = prefetch_to_device(build_data_iterator(cfg), dev)
    generator = torch.Generator(device=dev)
    losses, norms = [], []
    try:
        for _ in range(steps):
            generator.manual_seed(step_seed(cfg.trainer.seed, state.step))
            state, m = run_step(step_fn, state, next(batches), generator)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        batches.close()
    record = {"losses": losses, "grad_norms": norms,
              "weights": weights_digest(state.model.state_dict()),
              "teacher": weights_digest(state.teacher_encoder.state_dict())}
    del state, step_fn
    torch.cuda.empty_cache()
    return record


# (b)'s legs: (configuration file or None for the defaults, overrides, steps)
PARALLEL_LEGS = {"f32": (None, ["trainer.precision=f32"], PARALLEL_STEPS),
                 "bf16": (None, [], PARALLEL_STEPS),
                 "nat": (NAT_RECIPE, [], 1)}


def worker_gloo(out: str, port: int, rank: int) -> int:
    """Phase 13(b), one of two ranks on the one card in a gloo group made
    here: every leg of ``PARALLEL_LEGS``, their launches counted."""
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    counters = launch_counters()
    record = {}
    record["launches"] = counted_run(counters, lambda: record.update(
        {name: parallel_leg(*leg) for name, leg in PARALLEL_LEGS.items()}))
    with open(out, "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()
    return 0


def run_workers(cmds: dict, timeout: float, log_dir: str = PARALLEL_DIR) -> None:
    """Run each command (its output to ``log_dir/<name>.log``) and wait for
    all; one that fails, or the time limit, ends the rest. Raises with
    their output unless every one exited 0."""
    logs = {k: os.path.join(log_dir, f"{k.replace(' ', '_')}.log") for k in cmds}
    procs = {}
    for k, cmd in cmds.items():
        with open(logs[k], "w") as log:
            procs[k] = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs.values()):
        if (any(p.poll() not in (None, 0) for p in procs.values())
                or time.monotonic() > deadline):
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
        time.sleep(0.2)
    if any(p.returncode != 0 for p in procs.values()):
        raise AssertionError("; ".join(
            f"{k} exited {p.returncode}:\n{open(logs[k]).read()[-3000:]}"
            for k, p in procs.items()))


def run_files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def phase_parallel(counters: dict, train: dict) -> dict:
    """Phase 13: (a) both CLIs under ``torch.distributed.run --standalone
    --nproc_per_node=1`` over NCCL (a process of their own): exit 0, the
    files of one writer, the mono step p50 beside phase 5's, the denoise
    run's student served, the all-reduce's ms, bytes and GB/s; (b) two ranks
    on the one card over gloo against one process at the same seed: f32
    losses and gradient norms within phase 6's limits, weights and teacher
    bit for bit equal on both ranks, the bf16 losses' difference printed;
    one Nat step likewise."""
    import shutil
    import socket

    from wavjepa_tpu_torch.api.runtime import load_model
    from wavjepa_tpu_torch.train.config import Config, apply_overrides

    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    torch.cuda.empty_cache()
    record = {}
    me = os.path.abspath(__file__)
    # (a)
    out_a = os.path.join(PARALLEL_DIR, "torchrun_cli.json")
    train_dir = os.path.join(PARALLEL_DIR, "train")
    denoise_dir = os.path.join(PARALLEL_DIR, "denoise")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           me, "--parallel-worker", "torchrun_cli", out_a, train_dir, denoise_dir]
    t0 = time.perf_counter()
    run_workers({"torchrun": cmd}, 400)
    with open(out_a) as f:
        a = json.load(f)
    a["seconds"] = time.perf_counter() - t0
    cfg = apply_overrides(Config(), [])
    mcfg = cfg.build_model_config()
    enc, dec = mcfg.encoder_layers, mcfg.decoder_layers
    # a microbatch: the student encoder, the teacher and the predictor forward
    # and the first and last backward; the denoiser's teacher, clean and noisy
    # student forward and the noisy one's backward (α = 0); 16 and 4
    # microbatches at the CLIs' defaults
    mono, accum = (2 * enc + dec, enc + dec), cfg.resolved_accum_steps()
    expected = {"train": dict(zip(counters, (mono[0] * accum * TORCHRUN_STEPS,
                                             mono[1] * accum * TORCHRUN_STEPS, 0, 0))),
                "denoise": dict(zip(counters, (3 * enc * 4 * CLI_STEPS, enc * 4 * CLI_STEPS,
                                               0, 0)))}
    if a["launches"] != expected or a["backend"] != "nccl" or a["world"] != 1:
        raise AssertionError(f"torchrun CLIs: launches {a['launches']} (expected {expected}), "
                             f"backend {a['backend']}, world {a['world']}")
    for name, d, steps in (("train", train_dir, TORCHRUN_STEPS),
                           ("denoise", denoise_dir, CLI_STEPS)):
        files = run_files(d)
        metrics = [f for f in files if f.endswith("metrics.jsonl")]
        ckpts = [f for f in files if f.endswith(".ckpt")]
        events = [f for f in files if "tfevents" in f]
        rest = set(files) - set(metrics) - set(ckpts) - set(events)
        if (len(metrics) != 1 or len(ckpts) != 1 or not ckpts[0].endswith(f"{steps:08d}.ckpt")
                or len(events) > 1 or {os.path.basename(f) for f in rest} != {"model_config.json"}
                or len(rest) != 1):
            raise AssertionError(f"torchrun {name}: files {files}")
        with open(os.path.join(d, metrics[0])) as f:
            lines = [json.loads(line) for line in f]
        if [x["step"] for x in lines] != list(range(1, steps + 1)) or not all(
                np.isfinite(x["loss"]) for x in lines):
            raise AssertionError(f"torchrun {name}: metrics {lines}")
        a[name] = {"files": files, "losses": [x["loss"] for x in lines],
                   "step_ms": [x["step_time_ms"] for x in lines]}
    times = a["train"]["step_ms"][TRAIN_WARMUP:]
    a["train"]["step_p50_ms"] = statistics.median(times)
    base = train["accum_auto"]
    spread = base["step_ms"][TRAIN_WARMUP:]
    a["train"]["phase5_step_p50_ms"] = base["step_p50_ms"]
    a["train"]["phase5_spread_ms"] = [min(spread), max(spread)]
    a["train"]["within_phase5_spread"] = min(spread) <= a["train"]["step_p50_ms"] <= max(spread)
    a["allreduce_gb_per_s"] = a["allreduce_bytes"] / (a["allreduce_ms"] * 1e-3) / 1e9
    ckpt = os.path.join(denoise_dir, [f for f in a["denoise"]["files"] if f.endswith(".ckpt")][0])
    rt = load_model(ckpt)
    emb = rt.get_scene_embeddings(make_clips([10.0, 4.0], 43))
    torch.cuda.synchronize()
    if tuple(emb.shape) != (2, rt.embedding_size) or not torch.isfinite(emb).all():
        raise AssertionError(f"torchrun denoise: served {tuple(emb.shape)} from {ckpt}")
    a["denoise"]["served"] = list(emb.shape)
    del rt
    record["torchrun"] = a
    print(f"[parallel] torchrun --nproc_per_node=1 (NCCL, world 1): train CLI step p50 "
          f"{a['train']['step_p50_ms']:.1f} ms beside phase 5's {base['step_p50_ms']:.1f} "
          f"(its spread {min(spread):.1f}-{max(spread):.1f}; within: "
          f"{a['train']['within_phase5_spread']}), losses "
          f"{', '.join(f'{x:.5f}' for x in a['train']['losses'])}; denoise CLI losses "
          f"{', '.join(f'{x:.5f}' for x in a['denoise']['losses'])}, its student served "
          f"{tuple(emb.shape)}; one writer's files; the gradient all-reduce "
          f"{a['allreduce_ms']:.3f} ms for {a['allreduce_bytes'] / 1e9:.3f} GB "
          f"({a['allreduce_gb_per_s']:.1f} GB/s); launches {a['launches']}; "
          f"{a['seconds']:.1f} s with start-up", flush=True)
    shutil.rmtree(train_dir)
    shutil.rmtree(denoise_dir)
    # (b)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    outs = [os.path.join(PARALLEL_DIR, f"gloo_rank{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    cmds = {f"rank {r}": [sys.executable, me, "--parallel-worker", "gloo", outs[r], str(port),
                          str(r)] for r in range(2)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks beside one process
        waiter = pool.submit(run_workers, cmds, 400)
        alone = {name: parallel_leg(*leg) for name, leg in PARALLEL_LEGS.items()}
        waiter.result()
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    b = {"alone": alone, "ranks": ranks, "seconds": time.perf_counter() - t0}
    per_rank = {k: (2 * PARALLEL_STEPS + 1) * PARALLEL_ACCUM * n for k, n in
                zip(counters, (*mono, 0, 0))}
    for r, seen in enumerate(ranks):
        if seen["launches"] != per_rank:
            raise AssertionError(f"gloo rank {r}: launches {seen['launches']}, "
                                 f"expected {per_rank}")
        for name in PARALLEL_LEGS:
            if not all(np.isfinite(seen[name]["losses"])):
                raise AssertionError(f"gloo rank {r} {name}: losses {seen[name]['losses']}")
            for part in ("weights", "teacher"):
                if seen[name][part] != ranks[0][name][part]:
                    raise AssertionError(f"gloo {name}: rank {r}'s {part} differ from rank 0's")
    f32 = alone["f32"]
    loss_rel = max(abs(x - y) / abs(y) for seen in ranks
                   for x, y in zip(seen["f32"]["losses"], f32["losses"]))
    gn_rel = max(abs(x - y) / abs(y) for seen in ranks
                 for x, y in zip(seen["f32"]["grad_norms"], f32["grad_norms"]))
    if not (loss_rel <= STEP_LOSS_REL and gn_rel <= STEP_GRAD_NORM_REL):
        raise AssertionError(f"gloo f32, two ranks vs one process: loss rel {loss_rel} (limit "
                             f"{STEP_LOSS_REL}), grad_norm rel {gn_rel} (limit "
                             f"{STEP_GRAD_NORM_REL})")
    b["f32_loss_rel"], b["f32_grad_norm_rel"] = loss_rel, gn_rel
    for name in ("bf16", "nat"):
        b[f"{name}_loss_rel"] = max(abs(x - y) / abs(y) for x, y in
                                    zip(ranks[0][name]["losses"], alone[name]["losses"]))
    b["launches"] = {k: sum(seen["launches"][k] for seen in ranks) for k in counters}
    record["gloo"] = b
    print(f"[parallel] two ranks on one card (gloo), {PARALLEL_BATCH} clips a step, accum "
          f"{PARALLEL_ACCUM} (16 crops a rank's microbatch), against one process: f32 losses "
          f"{', '.join(f'{x:.6f}' for x in ranks[0]['f32']['losses'])} vs "
          f"{', '.join(f'{x:.6f}' for x in f32['losses'])} (max rel {loss_rel:.3g}, limit "
          f"{STEP_LOSS_REL}), grad_norm max rel {gn_rel:.3g} (limit {STEP_GRAD_NORM_REL}); "
          f"weights and teacher bit for bit equal on both ranks; bf16 loss max rel "
          f"{b['bf16_loss_rel']:.3g}, Nat step loss rel {b['nat_loss_rel']:.3g} (not gated); "
          f"launches {b['launches']}; {b['seconds']:.1f} s", flush=True)
    shutil.rmtree(PARALLEL_DIR)
    return record


# phase 14 (tensor parallel): configs/large.yaml, the 24 × 1024 encoder (16
# heads) and the 12 × 384 predictor, 8 clips × 8 crops a step in bf16, one
# pass by the resolved rule
LARGE_RECIPE = "configs/large.yaml"
LARGE_STEPS = 5  # (a): the first TRAIN_WARMUP left out of the p50
TP_DIR = os.path.join("build", "chip_smoke_tp")
TP = 2  # (b): trainer.model_parallel, two gloo ranks on the one card
TP_STEPS = 3
# (b)'s one cut: the large widths at 4 encoder and 2 predictor layers (24
# and 12 as configured), which every rank's all-reduces of activations
# through the host (gloo) would otherwise stretch past the phase's time
TP_ENCODER_LAYERS, TP_DECODER_LAYERS = 4, 2
# step-1 gradients, two ranks against one process, leaf by leaf:
# MULTICHIP_r05.json's gate (f32, the row-split products summed in another
# order); the bf16 step's loss within phase 6's bf16 limit of the f32 one's
TP_GRAD_RTOL, TP_GRAD_ATOL = 1e-5, 1e-6


def tp_leg(items: list, stops: tuple, save_dir: str, grads_to: str = "") -> dict:
    """``train_jepa`` on configs/large.yaml (synthetic clips, depth cut by
    ``run_tp_legs``) with ``items``, run from ``save_dir`` to each step of
    ``stops`` in turn: every run after the first resumes from the checkpoint
    that the one before it ended with (rank 0's file of the state that every
    rank gathered, cut again on restore). The digests of the whole weights
    and of the replicated leaves this rank holds; ``grads_to`` keeps the
    whole step-1 gradients (after the clip) there. Rank 0's metrics stay in
    ``save_dir``."""
    from wavjepa_tpu_torch.parallel.mesh import gather_params, tp_rule
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config
    from wavjepa_tpu_torch.train.loop import train_jepa

    cfg = apply_overrides(load_config(LARGE_RECIPE), [
        "data.synthetic=true", "optimizer.warmup_steps=2", "trainer.log_every=1",
        "trainer.keep_ckpts=1", f"trainer.save_dir={save_dir}", *items])
    for i, stop in enumerate(stops):
        state = train_jepa(cfg, max_steps=stop, device="cuda")
        if i == 0 and grads_to:
            grads = gather_params({k: p.grad for k, p in state.model.named_parameters()})
            torch.save({k: v.detach().cpu() for k, v in grads.items()}, grads_to)
    replicated = {k: v for k, v in state.model.named_parameters() if tp_rule(k) is None}
    record = {"weights": weights_digest(state.weights()),
              "replicated": weights_digest(replicated)}
    del state
    torch.cuda.empty_cache()
    return record


# (b)'s legs: (overrides, the steps each run of the leg stops at, keep the
# step-1 gradients)
TP_LEGS = {"f32": (["trainer.precision=f32"], (1, TP_STEPS), True),
           "bf16": ([], (TP_STEPS,), False),
           "fused": (["trainer.attn_impl=fused_block"], (1,), False)}
# phase 15(d), on the ranks alone: one f32 step with every stack replayed
FULL_REMAT = ("trainer.remat_conv=true", "trainer.remat_encoder=true",
              "trainer.remat_decoder=true")
TP_REMAT_LEG = {"f32_remat": (["trainer.precision=f32", *FULL_REMAT], (1,), True)}


def run_tp_legs(mp: int, run: str, grads: str, legs: dict = TP_LEGS) -> dict:
    """Every leg of ``legs`` at ``trainer.model_parallel`` ``mp`` under
    ``TP_DIR/run`` (a kept leg's step-1 gradients to ``<grads>_<leg>.pt``), at the model depth of
    TP_ENCODER_LAYERS and TP_DECODER_LAYERS (the configuration's model
    cut where ``build_run`` asks for it), with the local head counts that
    the transformer hands the flash kernels and the attention widths it
    hands the fused ones (read where it calls them; the counted wrappers
    stay as they are)."""
    from wavjepa_tpu_torch.ops import transformer
    from wavjepa_tpu_torch.train.config import Config

    seen = {"flash_heads": set(), "fused_widths": set()}
    flash, fused = transformer.flash_attention, transformer.fused_self_attention
    whole = Config.build_model_config

    def flash_spy(q, *args, **kw):
        seen["flash_heads"].add(q.shape[1])
        return flash(q, *args, **kw)

    def fused_spy(x, w_in, *args, **kw):
        seen["fused_widths"].add(w_in.shape[0] // 3)
        return fused(x, w_in, *args, **kw)

    def cut(self):
        return dataclasses.replace(
            whole(self), size="base", encoder_layers=TP_ENCODER_LAYERS,
            decoder_layers=TP_DECODER_LAYERS, average_top_k_layers=TP_ENCODER_LAYERS)

    transformer.flash_attention, transformer.fused_self_attention = flash_spy, fused_spy
    Config.build_model_config = cut
    try:
        record = {name: tp_leg([*items, f"trainer.model_parallel={mp}"], stops,
                               os.path.join(TP_DIR, run, name),
                               f"{grads}_{name}.pt" if keep else "")
                  for name, (items, stops, keep) in legs.items()}
    finally:
        transformer.flash_attention, transformer.fused_self_attention = flash, fused
        Config.build_model_config = whole
    record.update({k: sorted(v) for k, v in seen.items()})
    return record


def worker_tp(out: str, port: int, rank: int) -> int:
    """Phase 14(b), one of two ranks on the one card in a gloo group made
    here, at trainer.model_parallel=2: every leg of TP_LEGS and phase
    15(d)'s TP_REMAT_LEG, their launches counted."""
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=TP,
                            rank=rank)
    counters = launch_counters()
    record = {}
    record["launches"] = counted_run(counters, lambda: record.update(
        run_tp_legs(TP, "tp2", os.path.join(TP_DIR, f"grads_rank{rank}"),
                    {**TP_LEGS, **TP_REMAT_LEG})))
    with open(out, "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()
    return 0


def logged(save_dir: str) -> dict:
    """The steps, losses and gradient norms in a run's metrics (rank 0's)."""
    files = sorted(Path(save_dir).rglob("metrics.jsonl"))
    if len(files) != 1:
        raise AssertionError(f"{save_dir}: metrics files {files}")
    lines = [json.loads(x) for x in files[0].read_text().splitlines()]
    return {k: [x[key] for x in lines] for k, key in
            (("steps", "step"), ("losses", "loss"), ("grad_norms", "grad_norm"))}


def phase_tensor_parallel(counters: dict) -> dict:
    """Phase 14: (a) the first train step at large width on the card:
    train_jepa on configs/large.yaml as resolved at world size 1, bf16 on
    synthetic clips: step p50, clips/s, MFU, peak memory, exactly 72
    forward and 36 backward flash launches a step (24 + 24 + 12 layers
    forward and the predictor's 12 again, replayed in the backward as the
    JAX package resolves recomputation in one pass; 24 + 12 backward), the
    teacher moving less than the student,
    a HEAR request served from its checkpoint; (b) trainer.model_parallel=2
    as two gloo ranks on the one card, each through ``train_jepa`` (its
    ``build_run``, the loop's broadcast of a group's batch, its checkpoints)
    at the large widths (depth cut, see TP_ENCODER_LAYERS), against one
    process at the same seed: the f32 run stopped after step 1 and resumed
    from its checkpoint, its losses and gradient norms within phase 6's
    limits, step-1 gradients leaf by leaf at MULTICHIP_r05.json's gate, the
    replicated leaves and the whole weights bit for bit equal on both
    ranks, the last checkpoint served beside the one process's; the bf16
    steps' differences held to phase 6's bf16 limit; the flash kernels at 8
    and 6 local heads and, with attn_impl=fused_block, the fused kernels at
    A = 512 and 192. On the ranks alone, phase 15(d): one f32 step with
    every stack replayed, its step-1 gradients against the one process's
    f32 ones at the same gate."""
    import shutil
    import socket

    from wavjepa_tpu_torch.api.runtime import load_model

    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    torch.cuda.empty_cache()
    record = {"card": card_line()}
    # (a)
    large = phase_train(counters, [("large", [], LARGE_STEPS, dict(zip(counters, (72, 36, 0, 0))),
                                    True)], recipe=LARGE_RECIPE)["large"]
    if large["accum_steps"] != 1:
        raise AssertionError(f"large: {large['accum_steps']} microbatches, expected one pass")
    large["launches_per_step"] = {k: n // LARGE_STEPS for k, n in large["launches"].items()}
    record["large"] = large
    print(f"[tensor parallel] (a) large, world size 1: step p50 {large['step_p50_ms']:.1f} ms, "
          f"{large['clips_per_s']:.2f} clips/s, MFU {large['mfu']:.4f}, peak memory "
          f"{large['max_memory_allocated_bytes'] / 2**30:.2f} GiB, launches a step "
          f"{large['launches_per_step']}; {record['card']}", flush=True)
    torch.cuda.empty_cache()
    # (b)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    me = os.path.abspath(__file__)
    outs = [os.path.join(TP_DIR, f"rank{r}.json") for r in range(TP)]
    cmds = {f"tp rank {r}": [sys.executable, me, "--tp-worker", outs[r], str(port), str(r)]
            for r in range(TP)}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks beside one process
        waiter = pool.submit(run_workers, cmds, 400, TP_DIR)
        alone = run_tp_legs(1, "alone", os.path.join(TP_DIR, "grads_alone"))
        waiter.result()
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    b = {"alone": alone, "ranks": ranks, "seconds": time.perf_counter() - t0,
         "cut": {"encoder_layers": [24, TP_ENCODER_LAYERS],
                 "decoder_layers": [12, TP_DECODER_LAYERS]}}
    enc, dec = TP_ENCODER_LAYERS, TP_DECODER_LAYERS
    auto_steps = sum(stops[-1] for name, (_, stops, _) in TP_LEGS.items() if name != "fused")
    fused_steps = TP_LEGS["fused"][1][-1]
    remat_steps = TP_REMAT_LEG["f32_remat"][1][-1]
    # 64 crops, one pass: the predictor replayed as resolved; in the remat
    # leg the student encoder too
    per_rank = dict(zip(counters, (
        2 * (enc + dec) * auto_steps + (3 * enc + 2 * dec) * remat_steps,
        (enc + dec) * (auto_steps + remat_steps),
        2 * (enc + dec) * fused_steps, (enc + dec) * fused_steps)))
    for r, seen in enumerate(ranks):
        if seen["launches"] != per_rank:
            raise AssertionError(f"tp rank {r}: launches {seen['launches']}, expected {per_rank}")
        if seen["flash_heads"] != [6, 8] or seen["fused_widths"] != [192, 512]:
            raise AssertionError(f"tp rank {r}: flash at {seen['flash_heads']} local heads, "
                                 f"fused at widths {seen['fused_widths']}")
        for name in TP_LEGS:
            for part in ("weights", "replicated"):
                if seen[name][part] != ranks[0][name][part]:
                    raise AssertionError(f"tp {name}: rank {r}'s {part} differ from rank 0's")
    if alone["flash_heads"] != [12, 16] or alone["fused_widths"] != [384, 1024]:
        raise AssertionError(f"tp one process: heads {alone['flash_heads']}, widths "
                             f"{alone['fused_widths']}")
    # the metrics rank 0 and the one process logged: a step each, the f32
    # runs' steps 2 and 3 after the resume from step 1
    logs = {run: {name: logged(os.path.join(TP_DIR, run, name)) for name in TP_LEGS}
            for run in ("tp2", "alone")}
    for run, legs in logs.items():
        for name, seen in legs.items():
            if (seen["steps"] != list(range(1, TP_LEGS[name][1][-1] + 1))
                    or not all(np.isfinite(seen["losses"]))):
                raise AssertionError(f"tp {run} {name}: logged {seen}")
    b["logged"] = logs

    def rel(leg, key):
        return max(abs(x - y) / abs(y) for x, y in zip(logs["tp2"][leg][key],
                                                       logs["alone"][leg][key]))

    b["f32_loss_rel"], b["f32_grad_norm_rel"] = rel("f32", "losses"), rel("f32", "grad_norms")
    if not (b["f32_loss_rel"] <= STEP_LOSS_REL and b["f32_grad_norm_rel"] <= STEP_GRAD_NORM_REL):
        raise AssertionError(f"tp f32, two ranks vs one process: loss rel {b['f32_loss_rel']} "
                             f"(limit {STEP_LOSS_REL}), grad_norm rel {b['f32_grad_norm_rel']} "
                             f"(limit {STEP_GRAD_NORM_REL})")
    want = torch.load(os.path.join(TP_DIR, "grads_alone_f32.pt"))

    def worst_excess(leg: str) -> tuple[float, str]:
        """The ranks' step-1 gradients of ``leg`` against the one process's
        f32 ones: the largest |g - w| / (atol + rtol·|w|) and its leaf."""
        worst, worst_leaf = 0.0, ""
        for r in range(TP):
            got = torch.load(os.path.join(TP_DIR, f"grads_rank{r}_{leg}.pt"))
            if got.keys() != want.keys():
                raise AssertionError(f"tp rank {r} {leg}: gradient leaves differ from one "
                                     f"process's")
            for k, w in want.items():
                g = got[k].double()
                excess = ((g - w.double()).abs() / (TP_GRAD_ATOL + TP_GRAD_RTOL
                                                    * w.double().abs())).max().item()
                if excess > worst:
                    worst, worst_leaf = excess, f"rank {r} {k}"
        if worst > 1.0:
            raise AssertionError(f"tp {leg} step-1 gradients: {worst_leaf} at {worst:.3g}× the "
                                 f"limit (rtol {TP_GRAD_RTOL}, atol {TP_GRAD_ATOL})")
        return worst, worst_leaf

    worst, worst_leaf = worst_excess("f32")
    b["step1_grad_worst_over_limit"], b["step1_grad_worst_leaf"] = worst, worst_leaf
    b["step1_grad_leaves"] = len(want)
    # phase 15(d): the replayed step on the ranks, its loss beside their f32
    # leg's first (the same forward), its gradients at the same gate
    remat_log = logged(os.path.join(TP_DIR, "tp2", "f32_remat"))
    if remat_log["steps"] != [1] or not np.isfinite(remat_log["losses"]).all():
        raise AssertionError(f"tp f32_remat: logged {remat_log}")
    remat_worst, remat_leaf = worst_excess("f32_remat")
    b["remat"] = {"overrides": TP_REMAT_LEG["f32_remat"][0], "logged": remat_log,
                  "loss_vs_f32_leg": remat_log["losses"][0] - logs["tp2"]["f32"]["losses"][0],
                  "step1_grad_worst_over_limit": remat_worst,
                  "step1_grad_worst_leaf": remat_leaf}
    print(f"[recompute] (d) model_parallel=2, two gloo ranks, every stack replayed: f32 step-1 "
          f"loss {remat_log['losses'][0]:.6f} (the ranks' f32 leg "
          f"{logs['tp2']['f32']['losses'][0]:.6f}), step-1 gradients of {len(want)} leaves "
          f"against the one process's f32 step within rtol {TP_GRAD_RTOL} atol {TP_GRAD_ATOL} "
          f"(worst {remat_worst:.3g} of the limit, {remat_leaf}; without recomputation "
          f"{worst:.3g})", flush=True)
    b["bf16_loss_rel"], b["bf16_grad_norm_rel"] = rel("bf16", "losses"), rel("bf16", "grad_norms")
    b["fused_loss_rel"] = rel("fused", "losses")
    if not max(b["bf16_loss_rel"], b["fused_loss_rel"]) <= STEP_BF16_LOSS_REL:
        raise AssertionError(f"tp bf16, two ranks vs one process: loss rel {b['bf16_loss_rel']}, "
                             f"fused {b['fused_loss_rel']} (limit {STEP_BF16_LOSS_REL})")
    # the f32 runs' last checkpoints (each the whole model, one file), served
    served, ckpts, t1 = {}, {}, time.perf_counter()
    for run in ("tp2", "alone"):
        found = [str(p) for p in Path(TP_DIR, run, "f32").rglob("*.ckpt")]
        if len(found) != 1 or not found[0].endswith(f"step_{TP_STEPS:08d}.ckpt"):
            raise AssertionError(f"tp {run} f32: checkpoints {found}")
        ckpts[run] = found[0]
        rt = load_model(found[0])
        served[run] = rt.get_scene_embeddings(make_clips([10.0, 4.0], 43)).float()
        del rt
    tp2, one = (torch.load(ckpts[run], map_location="cpu", weights_only=False)["state_dict"]
                for run in ("tp2", "alone"))
    ckpt_diff = max((tp2[k] - v).abs().max().item() for k, v in one.items())
    del tp2, one
    b["checkpoints_s"] = time.perf_counter() - t1
    serve_rel = (torch.linalg.norm(served["tp2"] - served["alone"])
                 / torch.linalg.norm(served["alone"])).item()
    b["checkpoint_weights_max_abs_diff"], b["served_rel_fro"] = ckpt_diff, serve_rel
    if not (torch.isfinite(served["tp2"]).all() and serve_rel <= BF16_REL_FRO):
        raise AssertionError(f"tp f32 checkpoint served: relative Frobenius {serve_rel} to the "
                             f"one process's (limit {BF16_REL_FRO})")
    b["launches"] = {k: sum(seen["launches"][k] for seen in ranks) for k in counters}
    record["gloo"] = b
    print(f"[tensor parallel] (b) model_parallel=2, two gloo ranks on one card through "
          f"train_jepa, large widths at {enc} + {dec} layers (cut from 24 + 12): f32 run to "
          f"step 1, resumed from its checkpoint to {TP_STEPS}: losses "
          f"{', '.join(f'{x:.6f}' for x in logs['tp2']['f32']['losses'])} vs one process "
          f"{', '.join(f'{x:.6f}' for x in logs['alone']['f32']['losses'])} (max rel "
          f"{b['f32_loss_rel']:.3g}, limit {STEP_LOSS_REL}), grad_norm max rel "
          f"{b['f32_grad_norm_rel']:.3g} (limit {STEP_GRAD_NORM_REL}); step-1 gradients of "
          f"{len(want)} leaves within rtol {TP_GRAD_RTOL} atol {TP_GRAD_ATOL} (worst "
          f"{worst:.3g} of the limit, {worst_leaf}); replicated leaves and whole weights bit "
          f"for bit equal on both ranks; step-{TP_STEPS} checkpoint weights max abs "
          f"{ckpt_diff:.3g} from one process's, served (2 clips) at relative Frobenius "
          f"{serve_rel:.3g} (limit {BF16_REL_FRO}) in {b['checkpoints_s']:.1f} s; bf16 loss max "
          f"rel {b['bf16_loss_rel']:.3g}, grad_norm {b['bf16_grad_norm_rel']:.3g}, fused_block "
          f"loss {b['fused_loss_rel']:.3g} (limit {STEP_BF16_LOSS_REL}); flash at "
          f"{ranks[0]['flash_heads']} local heads, fused at A = {ranks[0]['fused_widths']}; "
          f"launches {b['launches']}; {b['seconds']:.1f} s", flush=True)
    shutil.rmtree(TP_DIR)
    return record


# phase 15 (recomputation): (a)'s settings beside phase 5's accum-1 run
# (name, overrides, flash forward launches a step; 24 backward), (c)'s
# steps and launches a step (24 + 24 + 12 layers forward, the student
# encoder's 24 and the predictor's 12 again; 24 + 12 backward)
REMAT_RUNS = (("remat_off", ["trainer.remat=false"], 36),
              ("remat_full", list(FULL_REMAT), 60),
              ("remat_full_save_probs", [*FULL_REMAT, "trainer.remat_save_probs=true"], 36))
LARGE_REMAT_LAUNCHES = dict(zip(COUNTER_NAMES, (96, 36, 0, 0)))


def phase_remat_parity(counters: dict, overrides: tuple = ()) -> dict:
    """Phase 15(b): phase 6's f32 injected step on the card with every stack
    replayed beside the same step with none, from the same seeded state and
    the same crops and masks: the loss bit for bit equal (the forward does
    not change), the updated weights, the teacher and the gradient norm
    within phase 6's limits (the packing's backward is an atomic
    scatter-add, so the gradients are not bit-equal between two runs); the
    launches of each step counted."""
    cfg, f32_cfg, crops, masks = parity_case(overrides)
    settings = {"off": dict(remat=False, remat_conv=False, remat_encoder=False,
                            remat_decoder=False),
                "full": dict(remat=True, remat_conv=True, remat_encoder=True,
                             remat_decoder=True)}
    steps, launches = {}, {}
    for name, flags in settings.items():
        launches[name] = counted_run(counters, lambda: steps.__setitem__(name, injected_step(
            cfg, dataclasses.replace(f32_cfg, **flags), "cuda", crops, masks)))
    off, full = steps["off"], steps["full"]
    lr = off[2]
    gn_rel = abs(full[1] - off[1]) / abs(off[1])
    w_err = max((full[3][k] - off[3][k]).abs().max().item() for k in off[3])
    t_err = max((full[4][k] - off[4][k]).abs().max().item() for k in off[4])
    layers = 2 * f32_cfg.encoder_layers + f32_cfg.decoder_layers
    replay = f32_cfg.encoder_layers + f32_cfg.decoder_layers
    fused = f32_cfg.attn_impl == "fused_block"
    want = {name: dict(zip(counters, (0, 0, layers + n, replay) if fused
                           else (layers + n, replay, 0, 0)))
            for name, n in (("off", 0), ("full", replay))}
    if launches != want:
        raise AssertionError(f"remat parity {f32_cfg.attn_impl}: launches {launches}, "
                             f"expected {want}")
    if not (full[0] == off[0] and gn_rel <= STEP_GRAD_NORM_REL
            and w_err <= STEP_PARAM_ATOL_LR * lr and t_err <= STEP_TEACHER_ATOL):
        raise AssertionError(f"f32 step, every stack replayed vs none ({f32_cfg.attn_impl}): "
                             f"loss {full[0]!r} vs {off[0]!r}, grad_norm rel {gn_rel}, weights "
                             f"{w_err} (lr {lr}), teacher {t_err}")
    print(f"[recompute] (b) f32 step on the card, attn_impl {f32_cfg.attn_impl}, every stack "
          f"replayed vs none: loss {full[0]!r} vs {off[0]!r} (bit for bit), grad_norm rel "
          f"{gn_rel:.3g} (limit {STEP_GRAD_NORM_REL}), weights max abs {w_err:.3g} (limit "
          f"{STEP_PARAM_ATOL_LR * lr:.3g}), teacher {t_err:.3g} (limit {STEP_TEACHER_ATOL}); "
          f"launches {launches}", flush=True)
    return {"attn_impl": f32_cfg.attn_impl, "loss": [off[0], full[0]],
            "grad_norm": [off[1], full[1]], "grad_norm_rel": gn_rel,
            "weights_max_abs_err": w_err, "teacher_max_abs_err": t_err, "lr": lr,
            "launches": launches}


def large_unreplayed_peak() -> dict:
    """Phase 15(c)'s yardstick: one step of configs/large.yaml at its 64
    crops with no recomputation (``build_run``, no checkpoint): the memory
    its state keeps after the step (weights, gradients, the teacher, the
    AdamW moments), the step's peak, and the peak that implies for 256
    crops in one pass, state + 4 × (peak − state)."""
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config
    from wavjepa_tpu_torch.train.loop import build_data_iterator, build_run

    cfg = apply_overrides(load_config(LARGE_RECIPE), ["data.synthetic=true",
                                                      "trainer.remat=false"])
    torch.cuda.empty_cache()
    dev, model_cfg, state, step_fn = build_run(cfg, "cuda")
    batch = torch.from_numpy(next(build_data_iterator(cfg))).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = step_fn(state, batch, torch.Generator(device=dev).manual_seed(0))
    loss = float(m["loss"])
    torch.cuda.synchronize()
    peak, kept = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    del state, step_fn, batch, m
    torch.cuda.empty_cache()
    crops = cfg.trainer.batch_size * cfg.data.samples_per_audio
    return {"crops": crops, "loss": loss, "kept_bytes": kept, "peak_bytes": peak,
            "implied_256_crops_bytes": kept + (256 // crops) * (peak - kept)}


def phase_recompute(counters: dict, train: dict, tensor_parallel: dict) -> dict:
    """Phase 15: recomputation (``trainer.remat*``) on the card. (a) the
    AudioSet configuration at accum 1 with recomputation off, every stack
    replayed, and every stack with the attention core kept
    (``remat_save_probs``), each through ``train_jepa`` with phase 5's
    checks and its launches, beside phase 5's accum-1 run (the JAX
    package's resolution: the predictor replayed); (b) ``phase_remat_parity``
    on the default path and with ``attn_impl=fused_block``; (c) the large
    model at the AudioSet batch (32 × 8 crops) in one pass with every stack
    replayed, beside the 256-crop peak that one 64-crop step without
    recomputation implies; (d) read from phase 14(b), whose ranks ran it.
    The MFU counts model FLOPs without the replays (``utils/flops.py``)."""
    record = {"card": card_line()}
    runs = phase_train(counters, [
        (name, ["trainer.accum_steps=1", *extra], TRAIN_STEPS_ONE_PASS,
         dict(zip(counters, (fwd, 24, 0, 0))), False) for name, extra, fwd in REMAT_RUNS])
    record["train"] = {"jax_resolution": train["accum_1"], **runs}
    print(f"[recompute] (a) AudioSet configuration, 32 clips × 8 crops in one pass, "
          f"{record['card']}:", flush=True)
    for name, r in record["train"].items():
        per_step = {k: n // r["steps"] for k, n in r["launches"].items()}
        print(f"[recompute] (a) {name}: step p50 {r['step_p50_ms']:.1f} ms, "
              f"{r['clips_per_s']:.2f} clips/s, {r['crops_per_s']:.1f} crops/s, MFU "
              f"{r['mfu']:.4f} (replays not counted), peak memory "
              f"{r['max_memory_allocated_bytes'] / 2**30:.2f} GiB, flash launches a step "
              f"{per_step['flash_attention_fwd']} forward / {per_step['flash_attention_bwd']} "
              f"backward", flush=True)
    torch.cuda.empty_cache()
    record["parity"] = {"default": phase_remat_parity(counters),
                        "fused_block": phase_remat_parity(
                            counters, ("trainer.attn_impl=fused_block",))}
    yardstick = large_unreplayed_peak()
    large = phase_train(counters, [
        ("large_remat_256", ["trainer.batch_size=32", "trainer.accum_steps=1", *FULL_REMAT],
         TRAIN_STEPS_ONE_PASS, LARGE_REMAT_LAUNCHES, False)], recipe=LARGE_RECIPE
    )["large_remat_256"]
    large["unreplayed_64"] = yardstick
    peak, card_bytes = large["max_memory_allocated_bytes"], torch.cuda.mem_get_info()[1]
    if large["accum_steps"] != 1 or not peak < card_bytes:
        raise AssertionError(f"large at 256 crops: {large['accum_steps']} microbatches, peak "
                             f"{peak / 2**30:.2f} GiB")
    record["large"] = large
    print(f"[recompute] (c) configs/large.yaml, 32 clips × 8 crops in one pass, every stack "
          f"replayed: step p50 {large['step_p50_ms']:.1f} ms, {large['clips_per_s']:.2f} "
          f"clips/s, MFU {large['mfu']:.4f} (replays not counted), peak memory "
          f"{peak / 2**30:.2f} GiB of the card's {card_bytes / 2**30:.2f}; one 64-crop step "
          f"without recomputation peaked at {yardstick['peak_bytes'] / 2**30:.2f} GiB over "
          f"{yardstick['kept_bytes'] / 2**30:.2f} kept, which implies "
          f"{yardstick['implied_256_crops_bytes'] / 2**30:.2f} GiB at 256 crops (not run); "
          f"{record['card']}", flush=True)
    record["tensor_parallel"] = tensor_parallel["gloo"]["remat"]
    return record


# phase 16 (LibriSpeech): configs/librispeech.yaml trained from FLAC shards
# in LibriSpeech's layout (8 shards of 8 utterances of 16 kHz mono, at the
# corpus's mean length, 12.30 s, one at its 35-s maximum:
# data/synthetic.librispeech_durations), and the AudioSet configuration from
# AudioSet-layout FLAC shards (8 shards of 4 clips of 10 s, 44.1 kHz
# stereo); both written here by the port's FLAC writer, in parallel
# processes, and deleted at the end
LIBRI_DIR = os.path.join("build", "chip_smoke_librispeech")
LIBRI_SHARDS, LIBRI_PER_SHARD = 8, 8
AUDIOSET_FLAC_SHARDS, AUDIOSET_FLAC_PER_SHARD = 8, 4
LIBRI_RECIPE = "configs/librispeech.yaml"
# the steps of (b) the CLI, (c) the 4.02-s form and (e) AudioSet: the first
# (the allocator's growth, the loader's first batch) left out of the p50s,
# three timed
LIBRI_CLI_STEPS = LIBRI_402_STEPS = AUDIOSET_FLAC_STEPS = 4
LIBRI_WARMUP = 1
# the shuffle buffer of (b) and (c), one batch of the recipe, cut from the
# default 1000 clips for the script's time (the CLI's first step waits for
# its fill)
LIBRI_SHUFFLE_BUFFER = 64
# launches a microbatch of the recipe (packing off, so the frontend and the
# encoder are replayed in the backward as the JAX package resolves it): 12
# layers each of the student encoder, its replay, the teacher and the
# predictor forward; the student encoder and the predictor backward
LIBRI_LAUNCHES = dict(zip(COUNTER_NAMES, (48, 24, 0, 0)))
LIBRI_RE = r"^\d+-\d+-\d{4}$"  # {speaker}-{chapter}-{utterance:04d}


def flac_worker_ms(samples: dict) -> dict:
    """One worker's ms a clip (decode, first channel, resample to 16 kHz,
    −14 dBFS, 10 s, int16) for a shard's FLAC payload against a PCM16 WAV
    payload of the same samples, rate and channels, timed in turns; and the
    FLAC decode alone. ``samples`` maps a name to (FLAC bytes, its samples
    (C, T) int16, rate)."""
    import io

    from scipy.io import wavfile

    from wavjepa_tpu_torch.data import decode, pipeline, resample

    def worker_clip(sample):
        wav, sr = decode.decode_audio(sample)
        wav = wav[:1]
        if sr != 16000:
            wav = resample.resample_np(wav, sr, 16000)
        return pipeline.quantize_clip_int16(pipeline.preprocess_clip(wav, 16000, 10.0))

    out = {}
    for name, (flac_bytes, pcm, sr) in samples.items():
        buf = io.BytesIO()
        wavfile.write(buf, sr, pcm.T.squeeze())
        flac_sample = {"flac": flac_bytes}
        wav_sample = {"wav": buf.getvalue()}
        if not np.array_equal(worker_clip(flac_sample), worker_clip(wav_sample)):
            raise AssertionError(f"{name}: the FLAC and WAV payloads give different clips")
        flac_ms, wav_ms = [], []
        for _ in range(2):  # FLAC, WAV, WAV, FLAC
            flac_ms.append(median_ms(lambda: worker_clip(flac_sample), 5))
            wav_ms.append(median_ms(lambda: worker_clip(wav_sample), 10))
            wav_ms.append(median_ms(lambda: worker_clip(wav_sample), 10))
            flac_ms.append(median_ms(lambda: worker_clip(flac_sample), 5))
        out[name] = {"seconds": pcm.shape[1] / sr, "sr": sr, "channels": pcm.shape[0],
                     "flac_ms": statistics.median(flac_ms), "wav_ms": statistics.median(wav_ms),
                     "flac_decode_ms": median_ms(lambda: decode.decode_audio(flac_sample), 10),
                     "flac_bytes_ratio": len(flac_sample["flac"]) / pcm.nbytes}
    return out


def phase_flac_shards() -> tuple[dict, str, str]:
    """Phase 16(a): LibriSpeech- and AudioSet-layout FLAC shards written by
    the port's writer; the native library built from the checkout on this
    host; every payload decoded bit for bit against the written samples; one
    worker's ms a clip for FLAC against WAV of the same samples. Returns
    the record and the two shard patterns."""
    import re
    import shutil

    from wavjepa_tpu_torch.data import decode, shards, synthetic
    from wavjepa_tpu_torch.data._native import build as native_build

    shutil.rmtree(LIBRI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    lib = native_build.build()  # phase 7 built it here; its path names the sources' hash
    # both layouts at once, the host's CPUs split between them by their
    # encoding work (the 44.1-kHz stereo clips take about twice the mono
    # utterances' in all)
    workers = os.cpu_count() or 2
    libri_workers = max(1, (workers + 2) // 3)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libri_job = pool.submit(synthetic.write_librispeech_shards,
                                os.path.join(LIBRI_DIR, "librispeech"), LIBRI_SHARDS,
                                LIBRI_PER_SHARD, workers=libri_workers)
        as_job = pool.submit(synthetic.write_audioset_shards, os.path.join(LIBRI_DIR, "audioset"),
                             AUDIOSET_FLAC_SHARDS, AUDIOSET_FLAC_PER_SHARD,
                             workers=max(1, workers - libri_workers))
        (libri_pattern, libri), (as_pattern, aset) = libri_job.result(), as_job.result()
    write_s = time.perf_counter() - t0
    record = {"library": str(lib), "write_s": write_s, "writer_processes": workers}
    t1, payloads = time.perf_counter(), {}
    for name, pattern, written, sr, members in (
            ("librispeech", libri_pattern, libri, 16000, {"flac", "txt"}),
            ("audioset", as_pattern, aset, 44100, {"flac", "json"})):
        n, flac_bytes, seconds = 0, 0, []
        for shard in shards.expand_shard_pattern(pattern):
            for key, sample in shards.iter_tar_samples(shard):
                key = os.path.basename(key)
                if set(sample) != members or (name == "librispeech"
                                              and not re.match(LIBRI_RE, key)):
                    raise AssertionError(f"{name} {key}: members {sorted(sample)}")
                wav, rate = decode.decode_audio(sample)
                if rate != sr or not np.array_equal(
                        wav, written[key].astype(np.float32) / 32768):
                    raise AssertionError(f"{name} {key}: decoded samples differ from written")
                n, flac_bytes = n + 1, flac_bytes + len(sample["flac"])
                payloads[key] = sample["flac"]
                seconds.append(wav.shape[1] / sr)
        if n != len(written):
            raise AssertionError(f"{name}: {n} samples read of {len(written)} written")
        record[name] = {"pattern": pattern, "clips": n, "audio_s": float(np.sum(seconds)),
                        "seconds_min_median_max": [min(seconds), statistics.median(seconds),
                                                   max(seconds)],
                        "flac_bytes": flac_bytes,
                        "bytes_ratio": flac_bytes / sum(v.nbytes for v in written.values())}
    record["verify_s"] = time.perf_counter() - t1
    mid = min(libri, key=lambda k: abs(libri[k].shape[1] / 16000 - 13.0))
    first = next(iter(aset))
    record["worker_ms"] = flac_worker_ms({
        "librispeech_16k_mono": (payloads[mid], libri[mid], 16000),
        "audioset_44k_stereo": (payloads[first], aset[first], 44100)})
    ls, au = record["librispeech"], record["audioset"]
    print(f"[librispeech] (a) FLAC shards written by the port's writer in {write_s:.1f} s "
          f"({workers} processes): LibriSpeech layout {ls['clips']} utterances, "
          f"{ls['audio_s']:.1f} s of audio (min / median / max "
          f"{' / '.join(f'{x:.2f}' for x in ls['seconds_min_median_max'])} s), "
          f"{ls['bytes_ratio']:.3f} of PCM16; AudioSet layout {au['clips']} clips of 10 s at "
          f"44.1 kHz stereo, {au['bytes_ratio']:.3f} of PCM16; all decoded bit for bit by "
          f"{lib.name} (g++, built on this host) in {record['verify_s']:.1f} s", flush=True)
    for name, r in record["worker_ms"].items():
        print(f"[librispeech] (a) one worker a clip, {name} ({r['seconds']:.2f} s): FLAC "
              f"{r['flac_ms']:.2f} ms (decode {r['flac_decode_ms']:.2f}) against WAV of the "
              f"same samples {r['wav_ms']:.2f} ms, in turns", flush=True)
    return record, libri_pattern, as_pattern


def sidecar_and_weights(run_dir: str, steps: int) -> tuple:
    """A run's last checkpoint, its sidecar's configuration and its student
    and teacher encoders' weights on the host."""
    from wavjepa_tpu_torch.train.checkpoint import read_model_config

    ckpt = os.path.join(run_dir, "ckpt", f"step_{steps:08d}.ckpt")
    if not (os.path.isfile(ckpt) and os.path.isfile(os.path.join(run_dir, "model_config.json"))):
        raise AssertionError(f"no checkpoint or model_config.json in {run_dir}")
    sd = torch.load(ckpt, map_location="cpu", weights_only=False)["state_dict"]
    student = {k[len("encoder."):]: v.float() for k, v in sd.items() if k.startswith("encoder.")}
    teacher = {k[len("teacher_encoder."):]: v.float() for k, v in sd.items()
               if k.startswith("teacher_encoder.")}
    return ckpt, read_model_config(ckpt), student, teacher


def phase_librispeech_cli(counters: dict, pattern: str) -> dict:
    """Phase 16(b): ``python -m wavjepa_tpu_torch.train
    configs/librispeech.yaml data.data_dirs=...`` as its ``main`` in this
    process (PyYAML reads the file), LIBRI_CLI_STEPS steps: exit 0,
    ``checked_run``'s checks at exactly LIBRI_LAUNCHES a microbatch; its
    checkpoint and sidecar (the wav2vec2 spec, ``pos_embed``, 100 tokens)
    served by ``load_model``."""
    import shutil

    from wavjepa_tpu_torch.api.runtime import load_model
    from wavjepa_tpu_torch.ops.conv_frontend import WAV2VEC2_CONV_SPEC
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config

    cli_dir = os.path.join("build", "chip_smoke_train", "librispeech_cli")
    shutil.rmtree(cli_dir, ignore_errors=True)
    items = [f"data.data_dirs={pattern}", f"trainer.steps={LIBRI_CLI_STEPS}",
             "trainer.log_every=1", "optimizer.warmup_steps=2", f"trainer.save_dir={cli_dir}",
             f"data.shuffle_buffer={LIBRI_SHUFFLE_BUFFER}"]
    argv = [LIBRI_RECIPE, *items]
    cfg = apply_overrides(load_config(LIBRI_RECIPE), items)
    start = seeded_encoder(cfg)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters.values():  # the main path's run starts here
        counter.launches = 0
    rc, stdout, cli_s = cli_in_process("wavjepa_tpu_torch.train", argv)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}  # read just after
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or f"[step {LIBRI_CLI_STEPS}] loss=" not in stdout:
        raise AssertionError(f"LibriSpeech CLI: exit {rc}\n{stdout[-3000:]}")
    run_dir = os.path.join(cli_dir, cfg.run_identity())
    ckpt, sidecar, student, teacher = sidecar_and_weights(run_dir, LIBRI_CLI_STEPS)
    rec = checked_run("LibriSpeech CLI", cfg, run_dir, LIBRI_CLI_STEPS, LIBRI_LAUNCHES,
                      launches, peak, start, student, teacher, LIBRI_WARMUP)
    if rec["accum_steps"] != 16:
        raise AssertionError(f"LibriSpeech CLI: {rec['accum_steps']} microbatches, not 16")
    if (sidecar.conv_spec != WAV2VEC2_CONV_SPEC or sidecar.pos_embed != "time"
            or sidecar.total_patches != 100 or sidecar.extractor_mode != "default"):
        raise AssertionError(f"LibriSpeech CLI: sidecar {sidecar}")
    # a HEAR request served from the checkpoint (architecture from the sidecar)
    rt, served = load_model(ckpt), {}
    serve = counted_run(counters, lambda: served.setdefault(
        "emb", rt.get_timestamp_embeddings(make_clips([10.0, 4.0], 16))[0]))
    emb = served["emb"]
    if (emb.dim() != 3 or emb.shape[0] != 2 or emb.shape[2] != sidecar.encoder_dim
            or not torch.isfinite(emb).all() or rt.config.total_patches != 100):
        raise AssertionError(f"LibriSpeech checkpoint served {tuple(emb.shape)}")
    del rt
    rec.update({"argv": argv, "seconds": cli_s,
                "sidecar": {"conv_spec": [list(x) for x in sidecar.conv_spec],
                            "pos_embed": sidecar.pos_embed,
                            "total_patches": sidecar.total_patches},
                "served": list(emb.shape), "serve_launches": serve})
    shutil.rmtree(cli_dir)  # ~1.7 GB of checkpoint
    print(f"[librispeech] (b) the CLI on {LIBRI_RECIPE} (its main in this process, "
          f"{cli_s:.1f} s): {run_summary(rec)}; checkpoint served {tuple(emb.shape)} from its "
          f"sidecar (wav2vec2 spec, 100 tokens)", flush=True)
    return rec


def phase_librispeech(counters: dict) -> dict:
    """Phase 16: (a) ``phase_flac_shards``; (b) ``phase_librispeech_cli``;
    (c) ``train_jepa`` on the recipe's 4.02-s form from the same shards,
    with phase 5's checks, its backward on the two-pass route; (d) phase
    6's injected step at the recipe's configuration (speech masks, the
    wav2vec2 frontend, unpacked, replayed as resolved), f32 card against
    CPU and bf16 against f32; (e) ``train_jepa`` on the AudioSet
    configuration from the AudioSet-layout FLAC shards, with phase 7's
    priming record."""
    import shutil

    from wavjepa_tpu_torch.ops import flash_attention as fam

    t0 = time.perf_counter()
    record = {"card": card_line()}
    record["flac"], libri_pattern, as_pattern = phase_flac_shards()
    record["cli"] = phase_librispeech_cli(counters, libri_pattern)
    torch.cuda.empty_cache()
    routes = {f"T{t}_d{d}": fam.flash_attention_bwd_route(t, d, torch.bfloat16)
              for t in (100, 200) for d in (64, 32)}
    if routes != {"T100_d64": "single_pass", "T100_d32": "single_pass",
                  "T200_d64": "two_pass", "T200_d32": "two_pass"}:
        raise AssertionError(f"the backward's routes at the recipe's shapes: {routes}")
    record["bwd_routes"] = routes
    record["train_402"] = phase_train(counters, [
        ("librispeech_402", ["data.process_seconds=4.02",
                             f"data.shuffle_buffer={LIBRI_SHUFFLE_BUFFER}"],
         LIBRI_402_STEPS, LIBRI_LAUNCHES, False)], shards=libri_pattern, warmup=LIBRI_WARMUP,
        recipe=LIBRI_RECIPE)["librispeech_402"]
    torch.cuda.empty_cache()
    record["parity"] = phase_train_parity(tag="librispeech parity", recipe=LIBRI_RECIPE)
    torch.cuda.empty_cache()
    record["audioset_flac"] = phase_train(counters, [
        ("audioset_flac", [f"data.shuffle_buffer={CLI_SHUFFLE_BUFFER}"], AUDIOSET_FLAC_STEPS,
         dict(zip(counters, (36, 24, 0, 0))), False)], shards=as_pattern, warmup=LIBRI_WARMUP
    )["audioset_flac"]
    primed = record["audioset_flac"]["primed"]
    if primed["first"] != {"shape": [32, 1, 160000], "dtype": "int16", "peak": 32767}:
        raise AssertionError(f"AudioSet FLAC loader's first batch {primed['first']}")
    shutil.rmtree(LIBRI_DIR)
    record["seconds"] = time.perf_counter() - t0
    c, r4, af = record["cli"], record["train_402"], record["audioset_flac"]
    print(f"[librispeech] (c) 4.02-s form (200 tokens, the backward's route "
          f"{routes['T200_d64']}): step p50 {r4['step_p50_ms']:.1f} ms, {r4['clips_per_s']:.2f} "
          f"clips/s, MFU {r4['mfu']:.4f}, peak {r4['max_memory_allocated_bytes'] / 2**30:.2f} "
          f"GiB; (e) AudioSet configuration from FLAC shards: first batch after "
          f"{primed['buffer_s']:.2f} s, {primed['produced_clips_per_s']:.1f} clips/s produced, "
          f"step p50 {af['step_p50_ms']:.1f} ms, data wait p50 {af['data_wait_p50_ms']:.2f} ms; "
          f"(b) {c['step_p50_ms']:.1f} ms a 2.01-s step; phase 16 took {record['seconds']:.1f} "
          f"s; {record['card']}", flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on the card",
              file=sys.stderr)
        return 1
    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model
    from wavjepa_tpu_torch.models.jepa import JEPAConfig
    from wavjepa_tpu_torch.ops import _build
    from wavjepa_tpu_torch.ops import fused_attention_block as fab
    from wavjepa_tpu_torch.ops.flash_attention import flash_attention, flash_attention_fwd

    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    # f32 comparisons hold the maths in full f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    phase_s = {}

    def done(phase):
        phase_s[phase] = time.perf_counter() - t_start
        print(f"[time] {phase} done at {phase_s[phase]:.1f} s", flush=True)

    _build.build_all()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(f"[build] {len(_build.build_logs)} CUDA sources built in {build_s:.2f} s "
          f"for {torch.cuda.get_device_name(0)}", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    wgmma_by_function = sass_wgmma_counts(_build)
    wgmma = {name: sum(f.values()) for name, f in wgmma_by_function.items()}
    print(f"[build] HGMMA instructions (cuobjdump -sass): {wgmma}", flush=True)
    for name in ("flash_attention_fwd", "flash_attention_bwd", "fused_attention_block_fwd",
                 "fused_attention_block_bwd"):
        if not wgmma.get(name):
            raise AssertionError(f"{name}: no wgmma (HGMMA) in its machine code")
    # the backward's kernels one by one: each bf16 route's (d = 32 and 64)
    bwd_functions = wgmma_by_function["flash_attention_bwd"]
    for kernel in BWD_WGMMA_KERNELS:
        found = {f: n for f, n in bwd_functions.items() if kernel in f}
        print(f"[build] flash_attention_bwd {kernel}: HGMMA {sorted(found.values())}", flush=True)
        if not found or not all(found.values()):
            raise AssertionError(f"flash_attention_bwd {kernel}: HGMMA by function {found}")

    done("build")
    kernel_rows = phase_kernels(flash_attention)
    train_fwd_rows, train_bwd_rows = phase_train_kernels()
    fused_fwd_rows, fused_bwd_rows = phase_fused_kernels()
    products = phase_products()
    layer_norm_rows = phase_layer_norm()
    relbias_rows = phase_relbias()
    done("kernels")
    serve, default_requests, served = phase_serve(
        flash_attention_fwd, fab.fused_attention_block_fwd, load_model, chunk_padding)
    serve_fused, fused_requests, _ = phase_serve(
        fab.fused_attention_block_fwd, flash_attention_fwd, load_model, chunk_padding,
        config=JEPAConfig(attn_impl="fused_block", dtype=torch.bfloat16), reference=served)
    serve_fused["in_turns"] = phase_serve_turns(default_requests, fused_requests)
    bf16_runtime = default_requests[0][1]  # the windowed runtime
    del served, fused_requests
    serve_wavlm = phase_wavlm_serve()
    parity = phase_parity(load_model, JEPAConfig, bf16_runtime)
    done("serve, parity")
    counters = launch_counters()
    # launches a microbatch: 12 layers each of the student encoder, the
    # teacher and the predictor forward, the student encoder and the
    # predictor backward
    default_path = dict(zip(counters, (36, 24, 0, 0)))
    fused_decoder = dict(zip(counters, (24, 12, 12, 12)))
    train = phase_train(counters, [
        ("accum_auto", [], TRAIN_STEPS, default_path, True),
        ("accum_1", ["trainer.accum_steps=1"], TRAIN_STEPS_ONE_PASS, DECODER_REPLAYED, False),
    ], keep={"accum_auto": EVAL_DIR})
    train_fused = phase_train(counters, [
        ("fused_decoder", ["trainer.attn_impl_decoder=fused_block"], TRAIN_STEPS,
         fused_decoder, True),
    ])
    for name, per_microbatch in (("accum_auto", LAYER_NORM_PER_MICROBATCH),
                                 ("accum_1", LAYER_NORM_REPLAYED)):
        run = train[name]
        expected = {k: n * run["accum_steps"] * run["steps"] for k, n in per_microbatch.items()}
        if run["layer_norm_launches"] != expected:
            raise AssertionError(f"{name}: layer_norm32 launches {run['layer_norm_launches']}, "
                                 f"expected {expected}")
    base, fused = train["accum_auto"], train_fused["fused_decoder"]
    print(f"[train fused] beside phase 5 at accum {base['accum_steps']}: step p50 "
          f"{fused['step_p50_ms']:.1f} vs {base['step_p50_ms']:.1f} ms, "
          f"{fused['clips_per_s']:.2f} vs {base['clips_per_s']:.2f} clips/s, "
          f"{fused['crops_per_s']:.1f} vs {base['crops_per_s']:.1f} crops/s, peak memory "
          f"{fused['max_memory_allocated_bytes'] / 2**30:.2f} vs "
          f"{base['max_memory_allocated_bytes'] / 2**30:.2f} GiB", flush=True)
    done("train")
    train_parity = phase_train_parity()
    for counter in counters.values():
        counter.launches = 0
    train_parity_fused = phase_train_parity(("trainer.attn_impl=fused_block",),
                                            "train parity fused")
    # two steps on the card (f32, bf16) of 2 crops in one pass, every stack
    # fused: 48 forward (the predictor replayed) and 24 backward launches a
    # step, flash attention none
    launches = {k: c.launches for k, c in counters.items()}
    if launches != dict(zip(counters, (0, 0, 96, 48))):
        raise AssertionError(f"fused train parity launched {launches}")
    train_parity_fused["launches"] = launches
    path_rel = abs(train_parity_fused["loss_card"] - train_parity["loss_card"]) / abs(
        train_parity["loss_card"])
    if not path_rel <= FUSED_PATH_LOSS_REL:
        raise AssertionError(f"f32 step, fused path vs default path: loss rel {path_rel}")
    train_parity_fused["loss_rel_vs_default_path"] = path_rel
    print(f"[train parity fused] f32 step loss, fused vs default path on the card: "
          f"{train_parity_fused['loss_card']:.6f} vs {train_parity['loss_card']:.6f} "
          f"(rel {path_rel:.3g}, limit {FUSED_PATH_LOSS_REL})", flush=True)

    done("train parity")
    data, train_shards = phase_data(counters, train)
    done("data")
    trace = phase_trace(train, train_shards)
    done("trace")
    nat = phase_nat(counters)
    done("nat")
    ambisonic = phase_ambisonic(counters, nat)
    done("ambisonic nat")
    microbatch_graph = phase_microbatch_graph(counters)
    done("microbatch graph")
    denoise = phase_denoise(counters, nat["shards"])
    done("denoise")
    evaluation = phase_eval(counters)
    done("eval")
    arch_xares = phase_arch_xares(counters)
    done("eval arch/xares")
    parallel = phase_parallel(counters, train)
    done("parallel")
    tensor_parallel = phase_tensor_parallel(counters)
    done("tensor parallel")
    recompute = phase_recompute(counters, train, tensor_parallel)
    done("recomputation")
    librispeech = phase_librispeech(counters)
    done("librispeech")

    def entry(name, replaces, launches, head, rows):
        return {"name": name, "route": "cuda",
                "source": f"wavjepa_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": head["max_abs_err_bf16"], "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"], "shapes": rows}

    def by_path(kernel, serving=None):
        paths = {"serve": serving["launches"] if serving else 0}
        paths.update({f"train {name}": r["launches"][kernel]
                      for runs in (train, train_fused, train_shards, nat["train"],
                                   nat["train_shards"], ambisonic["train"],
                                   ambisonic["train_shards"], denoise["train"],
                                   denoise["train_shards"])
                      for name, r in runs.items()})
        paths.update({"serve hf": evaluation["hf"]["launches"][kernel],
                      "serve w2v2": evaluation["w2v2"]["launches"][kernel],
                      "eval embeddings": evaluation["harness"]["launches"][kernel]})
        paths.update({f"eval arch {mode}": r["launches"][kernel]
                      for mode, r in arch_xares["arch"]["modes"].items()})
        paths.update({"eval xares": arch_xares["xares"]["launches"][kernel],
                      "eval xares fused": arch_xares["xares"]["fused"]["launches"][kernel]})
        paths.update({f"parallel torchrun {name}": n[kernel]
                      for name, n in parallel["torchrun"]["launches"].items()})
        paths["parallel gloo 2 ranks"] = parallel["gloo"]["launches"][kernel]
        paths["tensor parallel large"] = tensor_parallel["large"]["launches"][kernel]
        paths["tensor parallel gloo 2 ranks"] = tensor_parallel["gloo"]["launches"][kernel]
        paths.update({f"recompute train {name}": r["launches"][kernel]
                      for name, r in recompute["train"].items() if name != "jax_resolution"})
        paths.update({f"recompute f32 step {impl}": sum(n[kernel] for n in r["launches"].values())
                      for impl, r in recompute["parity"].items()})
        paths["recompute large 256 crops"] = recompute["large"]["launches"][kernel]
        paths["librispeech cli"] = librispeech["cli"]["launches"][kernel]
        paths["serve librispeech"] = librispeech["cli"]["serve_launches"][kernel]
        paths["librispeech 4.02 s"] = librispeech["train_402"]["launches"][kernel]
        paths["audioset flac"] = librispeech["audioset_flac"]["launches"][kernel]
        return paths

    fwd = entry("flash_attention_fwd", "wavjepa_tpu/ops/flash_attention.py:39", 0,
                kernel_rows[0],  # the windowed HEAR batch, the default serving shape
                kernel_rows + train_fwd_rows)
    fwd["launches_by_path"] = by_path("flash_attention_fwd", serve)
    fwd["launches_by_path"]["serve nat"] = nat["serve"]["launches"]
    fwd["launches_by_path"]["serve ambisonic"] = ambisonic["serve"]["launches"][
        "flash_attention_fwd"]
    fwd["launches_by_path"]["serve denoise"] = denoise["train"]["denoise"]["serve"]["launches"]
    fwd["bf16_routes"] = {r["shape"]: "wgmma" for r in kernel_rows + train_fwd_rows}
    bwd = entry("flash_attention_bwd", "wavjepa_tpu/ops/flash_attention.py:58", 0,
                train_bwd_rows[2],  # one microbatch of the packed student encoder
                train_bwd_rows)
    bwd["launches_by_path"] = by_path("flash_attention_bwd")
    bwd["bf16_routes"] = {r["shape"]: r["route_bf16"] for r in train_bwd_rows}
    bwd["library_ms_is"] = "autograd through SDPA (same mask, dO) less SDPA's forward"
    fused_fwd = entry("fused_attention_block_fwd", "wavjepa_tpu/ops/fused_attention_block.py:47",
                      0, fused_fwd_rows[0],  # one microbatch of the packed decoder
                      fused_fwd_rows)
    fused_fwd["launches_by_path"] = by_path("fused_attention_block_fwd", serve_fused)
    fused_fwd["library_ms_is"] = "F.linear, SDPA (same mask), F.linear"
    fused_bwd = entry("fused_attention_block_bwd", "wavjepa_tpu/ops/fused_attention_block.py:71",
                      0, fused_bwd_rows[0], fused_bwd_rows)
    fused_bwd["launches_by_path"] = by_path("fused_attention_block_bwd")
    fused_bwd["library_ms_is"] = ("autograd through F.linear, SDPA, F.linear (same mask, g) "
                                  "less that chain's forward")
    for k in (fwd, bwd, fused_fwd, fused_bwd):
        k["launches"] = sum(k["launches_by_path"].values())
    norm = entry("layer_norm", "none: XLA fuses the norm on the TPU", 0,
                 layer_norm_rows[0],  # the student encoder's 256 crops
                 layer_norm_rows)
    norm["launches_by_path"] = {f"train {name} {k}": n for name, r in train.items()
                                for k, n in r["layer_norm_launches"].items()}
    norm["launches_by_path"]["serve wavlm"] = serve_wavlm["launches"]["layer_norm32_fwd"]
    norm["launches"] = sum(norm["launches_by_path"].values())
    norm["library_ms_is"] = "F.layer_norm in bf16 on the rounded sum (forward)"
    relbias = entry("relbias_flash_attention_fwd", "none: the JAX package has no WavLM", 0,
                    relbias_rows[0],  # a WavLM request of 16 utterances padded to 1,749 frames
                    relbias_rows)
    relbias["source"] = "wavjepa_tpu_torch/csrc/flash_attention_fwd.cu"
    relbias["launches_by_path"] = {"serve wavlm": serve_wavlm["launches"][
        "relbias_flash_attention_fwd"]}
    relbias["launches"] = sum(relbias["launches_by_path"].values())
    relbias["library_ms_is"] = "the bias materialised in bf16 with the key mask, then SDPA"
    kernels = [fwd, bwd, fused_fwd, fused_bwd, norm, relbias]
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "hgmma": wgmma,
                   "hgmma_by_function": wgmma_by_function, "products": products,
                   "kernels": kernels, "serve": serve, "serve_wavlm": serve_wavlm,
                   "serve_fused": serve_fused, "parity": parity, "train": train,
                   "train_fused": train_fused, "train_parity": train_parity,
                   "train_parity_fused": train_parity_fused, "data": data,
                   "train_shards": train_shards, "trace": trace, "nat": nat,
                   "microbatch_graph": microbatch_graph, "ambisonic": ambisonic,
                   "denoise": denoise, "eval": evaluation, "eval_arch_xares": arch_xares,
                   "parallel": parallel, "tensor_parallel": tensor_parallel,
                   "recompute": recompute, "librispeech": librispeech, "phase_s": phase_s,
                   "torch": torch.__version__, "cuda": torch.version.cuda}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:3] == ["--parallel-worker", "torchrun_cli"]:  # phase 13(a)'s rank
        sys.exit(worker_torchrun_cli(*sys.argv[3:]))
    if sys.argv[1:3] == ["--parallel-worker", "gloo"]:  # one of phase 13(b)'s ranks
        out, port, rank = sys.argv[3:]
        sys.exit(worker_gloo(out, int(port), int(rank)))
    if sys.argv[1:2] == ["--tp-worker"]:  # one of phase 14(b)'s ranks
        out, port, rank = sys.argv[2:]
        sys.exit(worker_tp(out, int(port), int(rank)))
    sys.exit(main())
