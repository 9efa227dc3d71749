#!/usr/bin/env python3
"""Drive the PyTorch port (``stable_diffusion_videos_tpu_torch``) on one
NVIDIA GPU and check it, phase by phase.  Run from the repository root:

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels

1. environment: toolchain and card; exits non-zero without CUDA;
2. build: the hand-written kernels from ``csrc/`` (nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch version at the SD 1.x
   walk's shapes, bf16 and f32, with max abs error and times (CUDA events):
   the kernel's, the plain version's, one PyTorch library call's computing
   the same function (``library``: ``scaled_dot_product_attention``, or
   ``group_norm`` then ``silu``; a yardstick the port never calls), and the
   bound: the least time the card could take (``bound``, by operations or
   by bytes) and the kernel's share of it.  bf16 attention is also held
   against the output's own scale, beside what that check reads for two
   planted faults.  The fp32 GroupNorm-backward rows are held to the plain
   backward computed in fp64, the (1, 256, 512, 512) row also on three
   draws of its own (``GN_BWD_SEEDS``); the backward rows and the split-statistics
   GroupNorm's are also timed queued behind a device sleep (their device
   time).  Also the host time of a bf16 attention call's TMA tensor maps;
4. golden: the full-geometry SD 1.x UNet, VAE decoder and VAE encoder (its
   posterior's mean and log-variance) in fp32 (TF32 off) against
   ``tests/goldens/sd1_full_geometry.npz``, which the JAX package's
   reference produced (its weights drawn on the host while phase 2's nvcc
   runs, as phase 5's bundle is drawn on the card);
5. main path: ``walk()`` at 512², pndm-50, CFG 7.5, batch 8, two dispatches,
   on random bf16 weights (N(0, 0.02), drawn on the card from seeded
   generators); the kernels' launch counts come from this run,
   with the launches of each shape, every one of which phase 3 checks;
6. fewstep: the few-step operating point on the same weights: ``walk()``
   with dpm-20 x DeepCache ``step_cache=2`` under "ends" (16 frames, warm
   seconds a dispatch and frames/s), one 8-frame dispatch of the ``fast``
   preset (pndm-50 x ``step_cache=3`` x ``guidance_interval=(0.1, 0.85)``,
   whose cond-only segments run the UNet at batch 8), the ``fast`` preset's
   ``walk()`` at its own default batch of 16 (UNet batch 32 under CFG; warm
   seconds a dispatch), and the full-width DeepCache splice at batch 16;
   each run's launches by shape, every one of which phase 3 checks;
7. distilled: the distilled point on the same weights: lcm-4 cond-only
   (``guidance_interval=(0.0, 0.0)``, guidance 1.0) under ``frozen_noise``
   at batch 8, a 16-frame ``walk()`` and warm seconds a dispatch with the KL
   decoder, then with the TAESD tiny decoder at its published geometry; one
   10-step CFG dispatch of 8 frames (UNet batch 16) per remaining sampler
   (ddim at eta 0 and 0.5, euler, euler_ancestral, lms, unipc), each
   sampler's steps on the card held against the same steps on the CPU in
   fp32; and ``decode_latents_tiled`` of (8, 4, 128, 128) latents (1024²
   frames) in 64-latent tiles overlapping by 16; each run's launches by
   shape, every one of which phase 3 checks;
8. families: SD 2.x and SDXL-base at their published widths on random bf16
   weights drawn on the card (each bundle's build time printed): SDXL-base ``walk()`` at
   1024², 2 prompts x 2 frames at its default batch of 1, pndm-50, CFG 7.5,
   warm seconds of one frame's dispatch, and one ``fast=True`` dispatch
   (``step_cache=2``); SD 2.1 768-v ``walk()`` at 768², 2 prompts x 4
   frames, ddim-50 under v-prediction, CFG 7.5, dispatch batch 8 (the
   bucket pads 4 frames to 8), and warm seconds of one 8-frame dispatch;
   each run's launches by shape, every one of which phase 3 checks (its
   rows of these families run in bf16 only, the walks' dtype, with each
   D=64 row also timed against the depth 80 that served it before the
   depth-64 instantiation, in turns on the device clock);
9. edit: the edit paths on phase 5's bundle and frames: the KL encoder on
   8 frames at 512² and through ``Engine(vae_tile=64, vae_tile_overlap=16)``
   on the same frames at 1024² (first call and least of 2 warm); the
   pipeline's img2img of the 8 frames at strength 0.6, CFG 7.5, under
   pndm-50 (the warm-up replayed from the entry) and ddim-50, beside a warm
   txt2img pndm-50 dispatch of 8; inpaint under pndm-50 with the left half
   masked and with nothing masked, each held against the source encoded
   and decoded;
   vid2vid of a 16-frame video written by the port's ``FrameWriter``
   (read back through ``probe_video``/``read_video_frames``) at strength
   0.5 with one shared field, batch 8, written out as a video with audio
   (frames/s for the whole call); the TAESD encoder on 8 frames (no hand-written kernel:
   timing only).  Then the SDXL refiner at its published widths (its UNet
   drawn, the SDXL VAE and bigG tower of phase 8 reused when it ran): one
   1024² img2img frame at strength 0.3, ddim-50 (15 steps), CFG 7.5, batch
   1, with build time and warm seconds (least of 2).  Each run's launches by
   shape, every one of which phase 3 checks (this phase's new rows in bf16
   only);
10. addons: the conditioning add-ons on phase 5's bundle, pndm-25
   (``LATER_STEPS``, as in phases 11 and 12), CFG 7.5,
   batch 8, 512², each add-on drawn at its published widths (bf16 but the
   IP-Adapter's projection and image tower, fp32; the ControlNets and the
   tower on the card from seeded generators): a ControlNet
   (lllyasviel/sd-controlnet-canny's geometry) walk of 16 frames on one
   edge map and its warm dispatch beside a plain one (in turns); one
   dispatch with two ControlNets under ``guess_mode``; vid2vid of 16 frames
   with ``control_from_source="canny"``; the walk again with the taps
   zeroed, whose frames must equal a plain walk's; the IP-Adapter SD 1.5
   image tower (OpenCLIP ViT-H/14) on the card against the CPU, an
   IP-Adapter walk of 16 frames and its warm dispatch, and a dispatch at
   ``ip_scale=0`` that must equal the plain one; a weighted prompt of two
   77-token windows, walked and timed; a kohya LoRA (rank 8 on every
   attention projection and resnet convolution) and a textual-inversion
   file written here and merged, each merged weight held to its delta,
   then one dispatch.  Each run's launches by shape, every one of which
   phase 3 checks (the IP rows at Sk=4 and the weighted rows at Sk=154,
   bf16);
11. post: post-processing and the opt-in levers on phase 5's bundle at
   512², pndm-25, CFG 7.5, batch 8, with a safety checker at the geometry
   of CompVis/stable-diffusion-safety-checker (OpenAI ViT-L/14, bf16 tower,
   fp32 head) drawn on the card from a seeded generator and a Real-ESRGAN
   x4plus RRDBNet (16.7M parameters) from a numpy seed, the net written as
   a ``.pth`` under
   ``params_ema`` and loaded back through ``upsample_weights=``: the
   upsampler in fp32 on the card against the CPU on a 32² crop (and two
   x2plus-shaped nets, 12 input channels, under ``params_ema`` and
   ``params``), 8 frames 512² -> 2048² timed in fp32 and bf16 with the
   peak memory; the checker's tower and head in fp32 against the CPU, a
   concept planted on one of 8 synthetic frames flagged on the card alone
   and blacked out by ``_postprocess``, ``check_safety`` timed; ToMe's
   plan, merge and unmerge at (16, 4096, 320) fp32 against the CPU,
   ``tome=0`` bit-equal to plain; FreeU's filter at the skips' shapes
   against the CPU, neutral factors within 2/255 of plain; ToMe 0.5 and
   FreeU dispatches timed in turns with plain ones; then the composite
   walk (safety, upsample, ToMe 0.5, FreeU, 2 prompts x 16 frames, the mp4
   at 2048²) and its resume after the last 8 PNGs go.  Each run's launches
   by shape, every one of which phase 3 checks (ToMe's level 0 at Sq = Sk
   = 2048, bf16);
12. serve: the serving path on phase 5's bundle at 512², pndm-25
   (``LATER_STEPS``, since PR 16; pndm-50 before), CFG 7.5:
   the bundle written as a diffusers directory (safetensors, each
   config.json at runwayml/stable-diffusion-v1-5's keys with the port's
   config values, a synthetic vocabulary) and loaded back with
   ``StableDiffusionWalkPipeline.from_pretrained`` (seconds; every
   parameter and an 8-frame dispatch's frames bit-equal); the HTTP server
   on that pipeline over real sockets: /health, /warmup of batches 1 and 16
   (seconds), one /generate (least of 3 warm; its PNG equal to
   ``generate()``'s), 16 concurrent /generate from 16 threads (wall time,
   images/s, the batcher's dispatches) beside 4 sequential ones, a /walk job
   of 8 frames (frames/s beside phase 5's, its progress and its video under
   the output root), /generate during a /walk equal to it served alone,
   DELETE of the walk (seconds to "cancelled", no container left),
   /img2img (equal to ``img2img()``) and /inpaint of a 512² PNG, /generate
   beside /warmup of dpm (the pndm image); a 16-request /generate under a
   memory cap between the batch-8 and batch-16 peaks, split in two and
   within 2/255 of the uncapped images; and ``python3 -m
   stable_diffusion_videos_tpu_torch serve --checkpoint DIR`` as a process,
   started with the phase so that it loads beside the in-process server,
   its image equal to the in-process server's.  Each counted run's launches
   by shape, every one of which phase 3 checks (the rows at UNet batch 2
   and VAE batch 1, bf16);
13. train: training on phase 5's bundle, gradients through both kernels'
   backward kernels: ``UNetTrainer`` on 64² latents of two structured
   images (the VAE's encode of them, batch 2) and their prompts' (2, 77,
   768) context, EMA on, 3 steps (losses finite, masters moved; seconds a
   step, least of the warm ones, and peak memory), warm steps with the
   attention backward's tensor-core path and its FMA path in turns, one
   step's gradients
   with ``remat`` bit-equal to those without, a checkpoint saved, the run
   stepped, restored and stepped again bit-equal; one fp32 step (TF32 off)
   of the full-width UNet at 32² latents, batch 1, its gradient on the card
   against the CPU's (cosine, max error over the largest, each leaf's
   relative L2); LoRA rank 8, 3
   steps (the base bit-unchanged), its ``.npz`` merged by ``apply_lora``
   and an 8-frame dispatch on the merge; ``LCMDistiller`` 2 steps at batch
   2 (the teacher's CFG call at batch 4); ``VAETrainer`` 2 steps at 512²,
   batch 1 (the D=512 attention backward at S=4096), its reconstruction
   PSNR.  Each counted run's forward and backward launches by shape, every
   one of which phase 3 checks (forward rows at UNet batch 4, the encoder at
   batch 2 and the fp32 UNet at 32²; backward rows in bf16 and fp32 beside
   the plain backward, autograd through the library calls and the bound;
   the bf16 attention rows also held to each gradient's own scale by a
   check that must reject three planted faults, each row's route named
   (fused or materialised, from the wrapper's route counters), and the FMA
   path checked and timed beside the tensor cores; every GroupNorm
   backward call in two kernel launches);
14. quality: the native bundle format, the trained checkpoints, LPIPS, the
   parity gate and ``validate`` (``models/io.py``, ``utils/``): phase 5's
   bundle saved through ``SDModels.save`` and loaded back onto the card
   (every parameter and an 8-frame pndm-25 dispatch bit-equal; the
   bundle's size, save and load seconds), then ``convert`` as a process on
   an SD 1.5-layout directory, run beside the trained checkpoints' runs
   (its bundle bit-equal to ``from_pretrained`` of the directory, both
   timed); the committed trained checkpoints
   (``tests/goldens/structured_bundle``, ``structured_lcm_bundle``) read by
   ``SDModels.load`` alone, onto the card in fp32 (TF32 off) and onto the
   CPU, their 8 structured prompts denoised under pndm-50, dpm-20 x
   ``step_cache=2`` "ends" and ``fast`` at CFG 3.0, and lcm-4 cond-only
   free and frozen (noise fields from numpy seeds), the card's frames
   within 2/255 of the CPU's at PSNR >= 50 dB and SSIM >= 0.999 on every
   frame, and once in bf16 against fp32; LPIPS AlexNet and VGG16 on random
   ``.npz`` weights at 512², 8 pairs, card against CPU (VGG on 2 pairs
   there) and ms a pair; the parity gate on the card against the CPU's
   gate walk (pass) and another model's (fail); ``run_validation`` of the
   trained bundle with that reference, that LPIPS file and a Real-ESRGAN
   x4plus file drawn here, every stage ``ok``.  Each card run's launches
   by shape, every one of which phase 3 checks (the trained checkpoints'
   rows in fp32 and bf16);
15. mesh: the multi-card layer (``parallel/``) on phase 5's bundle, saved
   and loaded by each rank of two, child processes of this script
   (``--mesh-child``, started first, so that they set up while this
   process works, and waited for within ``MESH_CHILD_TIMEOUT``; a rank that
   fails stops the others and fails the phase; bit-equality is held within
   one process; its bf16 dispatches run pndm-4, ``MESH_STEPS``): one
   rank over NCCL in this process, its 8-frame dispatch bit-equal to a one-rank engine's;
   two ranks sharing the card over gloo (their bytes card to card by CUDA
   IPC), and two ranks on two cards over NCCL when the host has them: a
   data-parallel walk of 16 frames (rank 0's video 16 frames) and
   its dispatch again, warm, equal to the walk's PNGs, each rank's rows
   bit-equal to a one-rank engine's dispatch of them; the safety flags of
   5 frames over
   data 2 equal to one rank's (a tiny checker with a planted concept);
   tensor parallel and spatially sharded over model 2: the final latents
   and the frames of an fp32 ddim-2 dispatch (TF32 off) within
   tests/test_parallel.py's tolerances of one rank's, and a bf16
   dispatch of 8 frames at PSNR >= 40 dB and SSIM >= 0.95 of one rank's
   (phase quality's bf16 bounds), each TP rank's memory after load within
   2% of ``param_bytes_per_device``; every launch key of every rank one
   that phase 3 checks (the TP attention at 4 heads, its norm2 at 16
   groups, the spatial attention at Sq = S/2, the split-statistics
   GroupNorm's two kernels).  Dispatch seconds of each layout are printed,
   labelled: two ranks on one card are no scaling figure.  In the same two
   ranks (PR 16): rank 0 serves the data-2 pipeline over sockets through
   the ordered channel while rank 1 follows it (one /generate
   bit-equal to one rank's ``generate()``, 16 concurrent ones merged into
   one dispatch, a /walk job of 8 frames written by rank 0, a walk
   cancelled by DELETE and a /generate after it; seconds printed);
   ControlNet (sd-controlnet-canny's geometry), IP-Adapter (4 tokens),
   ToMe 0.5 and FreeU under tensor parallelism and spatial sharding, each
   an fp32 ddim-2 dispatch (TF32 off) within tests/test_parallel.py's
   bounds of one rank's with the same add-on (computed in this process
   while the ranks run) and a warm bf16 dispatch of 8 frames at phase
   quality's bf16 bounds, both ranks equal, timed; then rank 1 alone
   capped by ``torch.cuda.set_per_process_memory_fraction`` (the cap
   searched as phase serve's): under tensor parallelism and spatial
   sharding over model 2, so that 4 frames fit and 8 do not, rank 1
   breaks its model group, the ranks agree, re-form the groups in place
   and split the 8-frame dispatch, its frames within 2/255 of the
   uncapped dispatch before it and equal on both ranks, the uncapped
   dispatch after it bit-equal to the one before, the re-form's seconds
   printed; over data 2, so that 4 rows a rank fit and 8 do not, the
   16-frame dispatch split on both ranks and within 2/255 of the unsplit
   one.  Then, in the same ranks, training over data 2 (``train_gloo2``, and ``train_nccl2``
   on two cards), the JAX trainers' layout: the UNet trainer in fp32 (TF32
   off) at 32² latents, global batch 4, clipping every step, its averaged
   gradient against one rank's on the whole batch (cosine, max error over
   the largest) and its masters after 2 steps within a twentieth of lr a
   step of one rank's; then in bf16 the UNet trainer (64² latents, global batch
   4, EMA; a checkpoint written by rank 0 after step 1 and restored on
   both ranks, the step after it bit-equal to the uninterrupted step 2),
   a rank-8 LoRA, the VAE trainer at 512² (global batch 2) and LCM
   distillation (global batch 4), each rank's masters, Adam moments, EMA
   and LCM target bit-equal to the other's after every step, the losses
   finite and equal; warm step seconds, each rank's peak memory and the
   gradient all-reduce's ms a step printed.  The one NCCL rank also takes
   a bf16 UNet training step, bit-equal to the trainer without a mesh.
   Every counted training run launches both backward kernels and no plain
   backward.

Every failure raises, so the script exits non-zero.  The last two lines are
the kernels' JSON record (the two forward kernels, the two backward ones
and the split-statistics GroupNorm's two) and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
#: scratch space inside the checkout (listed in .gitignore)
WORK = ROOT / "stable_diffusion_videos_tpu_torch" / "_build"
PHASES = ("env", "build", "kernels", "golden", "main", "fewstep",
          "distilled", "families", "edit", "addons", "post", "serve",
          "train", "quality", "mesh")
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       # the output's bf16 rounding plus sums taken in another order
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# the sampler math on the card against the CPU, fp32
SAMPLER_TOL = dict(atol=1e-5, rtol=1e-5)
# inpaint against the source encoded and decoded (frames in [0, 1], bf16):
# after the last step the kept latents are the source's exactly, so with
# nothing masked the frames are the source's round trip within one uint8
# step; with the left half masked the decoder's mid-block attention reads
# the regenerated half too, so the kept pixels may move a little, a mean of
# at most 0.01
INPAINT_KEPT = dict(keep_all_max=1 / 255, half_mean=0.01)
# bf16 attention is also held to the output's own scale: at S=4096 the flat
# 2e-2 is about one output std (softmax over ~1500 effective keys), so alone
# it would pass a kernel that drops a key tile.  Limits: max|out-ref| over
# max|ref|, and ||out-ref|| over ||ref||.
ATTN_SCALED = dict(max_ratio=0.05, rel_l2=1e-2)
# the bf16 attention backward is held to each gradient's own scale too: the
# flat 2e-2 is about a third of dq's, dk's and dv's typical size at S=4096.
# dq, dk and dv are bf16 roundings of fp32 sums (the tensor-core routes also
# round P and dS to bf16 before their products): about 2e-3 of relative L2
# and 1e-2 of the largest element.  At every row the check must reject
# three planted faults, each at 2.5e-2 or more: the last key tile dropped
# from dq, the last q tile dropped from dk and from dv, and dS = P∘dP with
# its D_i term left out (dq and dk).
ATTN_BWD_SCALED = dict(max_ratio=0.02, rel_l2=1e-2)
# (q rows, keys) of the tiles the bf16 routes sum over, as
# csrc/attention_backward.cu has them: the fused route's dk/dv kernel steps
# through q in tiles of 64 rows and its dq kernel through the keys in tiles
# of 64; the materialised route's GEMM steps its k loop (q rows for dk and
# dv, keys for dq) in tiles of 64.  A planted fault drops one such tile.
ATTN_BWD_TILES = {"fused": (64, 64), "materialised": (64, 64)}
# One H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W):
# operations/s by element size (bf16 on the tensor cores, fp32 on the FMA
# units) and device-memory bytes/s.  bound = max(operations/peak,
# bytes/rate), each input read once and each output written once.
PEAK_OPS = {2: 989e12, 4: 67e12}
PEAK_BYTES = 3.35e12

# (Sq, Sk, D) of the UNet's self- and cross-attentions at 512², 8 heads
UNET_ATTN = [(4096, 4096, 40), (4096, 77, 40), (1024, 1024, 80),
             (1024, 77, 80), (256, 256, 160), (256, 77, 160), (64, 64, 160),
             (64, 77, 160)]
# (B, Sq, Sk, H, D): the UNet's at CFG batch 16 and at batch 8 (the
# cond-only segments of limited-interval CFG), and the VAE decoder's
# mid-block attention at batch 8; then the ``fast`` walk's at its default
# dispatch batch of 16 frames: the UNet's at CFG batch 32 (its cond-only
# segments run at 16) and the decoder's at batch 16
ATTN_SHAPES = ([(16, sq, sk, 8, d) for sq, sk, d in UNET_ATTN]
               + [(8, 4096, 4096, 1, 512)]
               + [(8, sq, sk, 8, d) for sq, sk, d in UNET_ATTN]
               + [(32, sq, sk, 8, d) for sq, sk, d in UNET_ATTN]
               + [(16, 4096, 4096, 1, 512)])
# (C, H, W, eps, silu) of the UNet's GroupNorm calls at 512²: the resnets'
# (eps 1e-5, SiLU) and the transformers' input norms (1e-6, none)
UNET_GN = [(320, 64, 64, 1e-5, True), (320, 64, 64, 1e-6, False),
           (320, 32, 32, 1e-5, True), (640, 64, 64, 1e-5, True),
           (640, 32, 32, 1e-5, True), (640, 32, 32, 1e-6, False),
           (640, 16, 16, 1e-5, True), (960, 64, 64, 1e-5, True),
           (960, 32, 32, 1e-5, True), (1280, 32, 32, 1e-5, True),
           (1280, 16, 16, 1e-5, True), (1280, 16, 16, 1e-6, False),
           (1280, 8, 8, 1e-5, True), (1280, 8, 8, 1e-6, False),
           (1920, 32, 32, 1e-5, True), (1920, 16, 16, 1e-5, True),
           (2560, 16, 16, 1e-5, True), (2560, 8, 8, 1e-5, True)]
# (C, H, W, eps, silu) of the VAE decoder's GroupNorm calls at 512²
VAE_GN = [(512, 64, 64, 1e-6, True), (512, 64, 64, 1e-6, False),
          (512, 128, 128, 1e-6, True), (512, 256, 256, 1e-6, True),
          (256, 256, 256, 1e-6, True), (256, 512, 512, 1e-6, True),
          (128, 512, 512, 1e-6, True)]
# (shape NCHW, eps, silu): every GroupNorm the walks run, the UNet's at CFG
# batch 16 and at batch 8 (cond-only segments) and the VAE decoder's at
# batch 8, then the ``fast`` walk's UNet at CFG batch 32 and decoder at
# batch 16, with weights in x's dtype as the model's are.  Phases 5 and 6
# fail if a walk launches either kernel at a (shape, eps, silu, dtype) that
# phase 3 does not check.
GN_SHAPES = [((b, c, h, w), eps, silu)
             for b, table in ((16, UNET_GN), (8, VAE_GN), (8, UNET_GN),
                              (32, UNET_GN), (16, VAE_GN))
             for c, h, w, eps, silu in table]
# the (eps, silu) pair the walk does not use, with fp32 weights: the
# wrapper's other weight branch
GN_EXTRA = [((16, 320, 64, 64), 1e-5, False)]

# Phase 8's families, 64-channel heads at every UNet level.  SD 2.1 768-v at
# 768² (latents 96²): the SD 1.x UNet's structure with (5, 10, 20, 20)
# heads; (Sq, Sk, H) of its self- and cross-attentions
SD2_ATTN = [(9216, 9216, 5), (9216, 77, 5), (2304, 2304, 10),
            (2304, 77, 10), (576, 576, 20), (576, 77, 20), (144, 144, 20),
            (144, 77, 20)]
# SDXL-base at 1024² (latents 128²): attention at levels 1 (10 heads) and 2
# and the mid block (20 heads) only
XL_ATTN = [(4096, 4096, 10), (4096, 77, 10), (1024, 1024, 20),
           (1024, 77, 20)]
# (B, Sq, Sk, H, D): SD 2.x's UNet at CFG batch 16 and its decoder's
# mid-block at batch 8 (768²), SDXL's UNet at CFG batch 2 and its decoder's
# at batch 1 (1024²)
FAMILY_ATTN_SHAPES = ([(16, sq, sk, h, 64) for sq, sk, h in SD2_ATTN]
                      + [(8, 9216, 9216, 1, 512)]
                      + [(2, sq, sk, h, 64) for sq, sk, h in XL_ATTN]
                      + [(1, 16384, 16384, 1, 512)])
# SDXL's UNet GroupNorm calls at 1024², (C, H, W, eps, silu): three levels
# (320, 640, 1280) at 128², 64², 32², with the up path's concatenations
XL_UNET_GN = [(320, 128, 128, 1e-5, True), (320, 64, 64, 1e-5, True),
              (640, 64, 64, 1e-5, True), (640, 64, 64, 1e-6, False),
              (640, 32, 32, 1e-5, True), (1280, 32, 32, 1e-5, True),
              (1280, 32, 32, 1e-6, False), (2560, 32, 32, 1e-5, True),
              (1920, 32, 32, 1e-5, True), (1920, 64, 64, 1e-5, True),
              (1280, 64, 64, 1e-5, True), (960, 64, 64, 1e-5, True),
              (960, 128, 128, 1e-5, True), (640, 128, 128, 1e-5, True)]


def scaled_gn(table, num: int, den: int = 1):
    """A GroupNorm table at another image size: spatial sides x num/den."""
    return [(c, h * num // den, w * num // den, eps, silu)
            for c, h, w, eps, silu in table]


# SD 2.x's UNet (SD 1.x's structure) at 768² and CFG batch 16, its decoder
# at batch 8; SDXL's UNet at CFG batch 2 and its decoder at 1024², batch 1
# (groups of 8.4M elements, 16.8 MB, at (1, 256, 1024, 1024))
FAMILY_GN_SHAPES = [((b, c, h, w), eps, silu)
                    for b, table in ((16, scaled_gn(UNET_GN, 3, 2)),
                                     (8, scaled_gn(VAE_GN, 3, 2)),
                                     (2, XL_UNET_GN),
                                     (1, scaled_gn(VAE_GN, 2)))
                    for c, h, w, eps, silu in table]


# Phase 9's edit paths, in bf16.  The KL encoder's GroupNorm calls at 512²
# (C, H, W, eps, silu): two resnets a level at 512², 256², 128², 64² (each
# level's first resnet normalises the level above's channels), the mid
# block's resnets and attention norm, and conv_norm_out
VAE_ENC_GN = [(128, 512, 512, 1e-6, True), (128, 256, 256, 1e-6, True),
              (256, 256, 256, 1e-6, True), (256, 128, 128, 1e-6, True),
              (512, 128, 128, 1e-6, True), (512, 64, 64, 1e-6, True),
              (512, 64, 64, 1e-6, False)]
# the SDXL refiner's UNet at 1024² (latents 128²): levels (384, 768, 1536,
# 1536) at 128², 64², 32², 16², transformers at levels 1-2 and the mid
# block, then the up path's concatenations (up to 3072 channels, 96 a group)
REFINER_UNET_GN = [
    (384, 128, 128, 1e-5, True), (384, 64, 64, 1e-5, True),
    (768, 64, 64, 1e-5, True), (768, 64, 64, 1e-6, False),
    (768, 32, 32, 1e-5, True), (1536, 32, 32, 1e-5, True),
    (1536, 32, 32, 1e-6, False), (1536, 16, 16, 1e-5, True),
    (1536, 16, 16, 1e-6, False), (3072, 16, 16, 1e-5, True),
    (3072, 32, 32, 1e-5, True), (2304, 32, 32, 1e-5, True),
    (2304, 64, 64, 1e-5, True), (1536, 64, 64, 1e-5, True),
    (1152, 64, 64, 1e-5, True), (1152, 128, 128, 1e-5, True),
    (768, 128, 128, 1e-5, True)]
# (Sq, Sk, H) of the refiner's attentions, 64-channel heads: 12 heads at
# level 1, 24 at level 2 and in the mid block
REFINER_ATTN = [(4096, 4096, 12), (4096, 77, 12), (1024, 1024, 24),
                (1024, 77, 24), (256, 256, 24), (256, 77, 24)]


def new_rows(rows, *checked):
    """``rows`` less those already in the ``checked`` tables, in order."""
    seen = {r for table in checked for r in table}
    return [r for r in dict.fromkeys(rows) if r not in seen]


# the edit phase's keys that the earlier tables do not hold: the SD 1.x
# encoder at batch 8 (512², and the 512² tiles of a 1024² tiled encode) and
# the SDXL encoder at 1024², batch 1; the refiner's UNet at CFG batch 2
# (its encoder and decoder attention, at 4096 and 16384 positions, and its
# decoder's GroupNorm are the families' rows)
EDIT_GN_SHAPES = new_rows(
    [((b, c, h, w), eps, silu)
     for b, table in ((8, VAE_ENC_GN), (1, scaled_gn(VAE_ENC_GN, 2)),
                      (2, REFINER_UNET_GN))
     for c, h, w, eps, silu in table], GN_SHAPES, FAMILY_GN_SHAPES)
EDIT_ATTN_SHAPES = new_rows([(2, sq, sk, h, 64) for sq, sk, h in REFINER_ATTN],
                            ATTN_SHAPES, FAMILY_ATTN_SHAPES)
# Phase 10's add-ons on the SD 1.x UNet at 512² and CFG batch 16: the
# IP-Adapter's second cross-attention over 4 image tokens, and the text
# cross-attention over a weighted context of two 77-token windows, at each
# level's (Sq, D).  The ControlNet trunk runs the UNet's own down and mid
# keys.
UNET_LEVELS = [(4096, 40), (1024, 80), (256, 160), (64, 160)]
IP_TOKENS, WEIGHTED_KEYS = 4, 2 * 77
ADDON_ATTN_SHAPES = new_rows(
    [(16, sq, sk, 8, d) for sk in (IP_TOKENS, WEIGHTED_KEYS)
     for sq, d in UNET_LEVELS],
    ATTN_SHAPES, FAMILY_ATTN_SHAPES, EDIT_ATTN_SHAPES)
# Phase 12's serving path at 512²: a request of one prompt runs the UNet at
# CFG batch 2 and the decoder at batch 1, and /img2img and /inpaint the
# encoder at batch 1 too (a merged batch of 16, the walk and the split's
# halves run the walks' keys)
SERVE_ATTN_SHAPES = new_rows(
    [(2, sq, sk, 8, d) for sq, sk, d in UNET_ATTN]
    + [(1, 4096, 4096, 1, 512)],
    ATTN_SHAPES, FAMILY_ATTN_SHAPES, EDIT_ATTN_SHAPES, ADDON_ATTN_SHAPES)
SERVE_GN_SHAPES = new_rows(
    [((b, c, h, w), eps, silu)
     for b, table in ((2, UNET_GN), (1, VAE_GN), (1, VAE_ENC_GN))
     for c, h, w, eps, silu in table],
    GN_SHAPES, FAMILY_GN_SHAPES, EDIT_GN_SHAPES)
# Phase 13's training at 512² (64² latents): the UNet forward and backward
# at batch 2 (the UNet and LoRA trainers, the distiller's student), the
# distiller's teacher at CFG batch 4 (forward only), the encoder at batch 2
# (the training images' latents, forward only), the VAE trainer's encoder
# and decoder at batch 1 (forward and backward); and one fp32 step of the
# UNet at 32² latents, batch 1.  Forward rows the tables above lack, bf16:
TRAIN_ATTN_SHAPES = new_rows(
    [(4, sq, sk, 8, d) for sq, sk, d in UNET_ATTN]
    + [(2, 4096, 4096, 1, 512)],
    ATTN_SHAPES, FAMILY_ATTN_SHAPES, EDIT_ATTN_SHAPES, ADDON_ATTN_SHAPES,
    SERVE_ATTN_SHAPES)
TRAIN_GN_SHAPES = new_rows(
    [((b, c, h, w), eps, silu)
     for b, table in ((4, UNET_GN), (2, VAE_ENC_GN))
     for c, h, w, eps, silu in table],
    GN_SHAPES, FAMILY_GN_SHAPES, EDIT_GN_SHAPES, SERVE_GN_SHAPES)
# the fp32 step's UNet at 32² latents (forward and backward, fp32 weights)
TRAIN_FP32_ATTN_SHAPES = [(1, sq // 4, sk if sk == 77 else sk // 4, 8, d)
                          for sq, sk, d in UNET_ATTN]
TRAIN_FP32_GN_SHAPES = [((1, c, h, w), eps, silu)
                        for c, h, w, eps, silu in scaled_gn(UNET_GN, 1, 2)]
# phase mesh's fp32 training check: the UNet at 32² latents on each of two
# data ranks (2 rows of a global batch of 4) and on one rank (the whole
# batch), forward and backward, fp32 weights.  Phase 3 draws these rows'
# inputs from a generator of their own, so the earlier rows keep theirs
MESH_TRAIN_FP32_ATTN_SHAPES = [(b, *s[1:]) for b in (2, 4)
                               for s in TRAIN_FP32_ATTN_SHAPES]
MESH_TRAIN_FP32_GN_SHAPES = [((b, *shape[1:]), eps, silu) for b in (2, 4)
                             for shape, eps, silu in TRAIN_FP32_GN_SHAPES]
# the backward kernels' keys, in bf16 (each also checked in fp32): the UNet
# at batch 2, the VAE's mid-block attention and its encoder's and decoder's
# GroupNorms at batch 1
BWD_ATTN_SHAPES = ([(2, sq, sk, 8, d) for sq, sk, d in UNET_ATTN]
                   + [(1, 4096, 4096, 1, 512)])
BWD_GN_SHAPES = list(dict.fromkeys(
    ((b, c, h, w), eps, silu)
    for b, table in ((2, UNET_GN), (1, VAE_GN), (1, VAE_ENC_GN))
    for c, h, w, eps, silu in table))
# the card's fp32 gradient of the full-width UNet against the CPU's (TF32
# off on the card): both sum the same terms in fp32 in other orders, through
# the UNet's depth, forward and back.  The whole tree: cosine within 1e-4 of
# 1, largest error within 1e-5 of the largest element (7.0e-7 read on an
# H100).  Each leaf (every weight tensor, down to the GroupNorms' scales and
# biases) to its own scale, so that a fault in a few small tensors does not
# hide in the tree's sums: relative L2 within 1e-3.  On an H100 the median
# leaf reads 2e-6 and the worst 1.2e-4 (the level-0 self-attentions' to_q
# and to_k)
TRAIN_GRAD_TOL = dict(cosine=1.0 - 1e-4, max_err=1e-5, leaf_rel_l2=1e-3)
# the LoRA merge against its delta: the merged bf16 weight is the fp32 sum
# W + delta rounded once, within half an ulp (2^-8 relative) of it, plus the
# fp32 sums' own rounding (the check's delta is a matmul, the merge's an
# einsum; 9 terms at 2^-24 each) relative to the sum of the terms' sizes,
# |W| + |up|·|down|, which cancellation can leave far above |W + delta|
LORA_MERGE_RTOL = 2.0 ** -8
LORA_MERGE_FP32 = 1e-6
# the IP-Adapter's image tower (fp32, TF32 off) on the card against the CPU
TOWER_TOL = dict(atol=1e-4, rtol=1e-4)
# Phase 11: ToMe at ratio 0.5 merges floor(0.5 S) of the level-0 tokens,
# so the UNet's level-0 self-attention runs at Sq = Sk = 2048 (CFG batch 16)
TOME_RATIO = 0.5
TOME_S = 4096 - int(TOME_RATIO * 4096)
POST_ATTN_SHAPES = new_rows([(16, TOME_S, TOME_S, 8, 40)], ATTN_SHAPES,
                            FAMILY_ATTN_SHAPES, EDIT_ATTN_SHAPES,
                            ADDON_ATTN_SHAPES)
# Phase 14 on the committed trained checkpoints (tests/goldens/
# structured_bundle and structured_lcm_bundle: UNet levels (64, 128) at 16²
# and 8² latents with 4 heads, D=16 and 32; the KL decoder's mid-block
# attention over 64 channels, one head, at 16² latents): the UNet's (Sq, Sk,
# H, D), at CFG batch 16 (8 prompts), 8 (cond-only segments, lcm-4, the
# gate's walk of 4 frames under CFG), 2 (validate's smoke frame and step
# curve) and 1 (their cond-only segments); the decoder's at 8, 4 and 1, the
# encoder's at 1
STRUCTURED_UNET_ATTN = [(256, 256, 4, 16), (256, 77, 4, 16),
                        (64, 64, 4, 32), (64, 77, 4, 32)]
QUALITY_ATTN_SHAPES = ([(b, *a) for b in (16, 8, 2, 1)
                        for a in STRUCTURED_UNET_ATTN]
                       + [(b, 256, 256, 1, 64) for b in (8, 4, 1)])
# (C, H, W, eps, silu): the UNet's resnets and transformer norms (2 and 4
# channels a group, up to 8 on the up path's concatenations), the KL
# decoder's and the encoder's (1 and 2 channels a group)
STRUCTURED_UNET_GN = [(64, 16, 16, 1e-5, True), (64, 16, 16, 1e-6, False),
                      (64, 8, 8, 1e-5, True), (128, 8, 8, 1e-5, True),
                      (128, 8, 8, 1e-6, False), (256, 8, 8, 1e-5, True),
                      (192, 8, 8, 1e-5, True), (192, 16, 16, 1e-5, True),
                      (128, 16, 16, 1e-5, True)]
STRUCTURED_DEC_GN = [(64, 16, 16, 1e-6, True), (64, 16, 16, 1e-6, False),
                     (64, 32, 32, 1e-6, True), (32, 32, 32, 1e-6, True)]
STRUCTURED_ENC_GN = [(32, 32, 32, 1e-6, True), (32, 16, 16, 1e-6, True),
                     (64, 16, 16, 1e-6, True), (64, 16, 16, 1e-6, False)]
QUALITY_GN_SHAPES = list(dict.fromkeys(
    [((b, c, h, w), eps, silu) for b in (16, 8, 2, 1)
     for c, h, w, eps, silu in STRUCTURED_UNET_GN]
    + [((b, c, h, w), eps, silu) for b in (8, 4, 1)
       for c, h, w, eps, silu in STRUCTURED_DEC_GN]
    + [((1, c, h, w), eps, silu) for c, h, w, eps, silu in
       STRUCTURED_ENC_GN]))
# Phase 15's layouts over two model ranks, on phase 5's bundle at 512², 8
# frames (UNet CFG batch 16, decoder batch 8), fp32 and bf16.  Tensor
# parallel: the UNet's attention at half its heads; each resnet's norm2 on
# half its output channels at 16 groups, in the UNet and in the decoder
# (whose single-head attention stays whole).  Spatial: the UNet's
# self-attention with Sq = S/2 queries against Sk = S keys, its
# cross-attention at Sq = S/2; every UNet GroupNorm through the
# split-statistics kernels on half the width.  The data-parallel walk runs
# the walks' keys.
MESH_RANKS = 2
MESH_ATTN_SHAPES = new_rows(
    [(16, sq, sk, 8 // MESH_RANKS, d) for sq, sk, d in UNET_ATTN]
    + [(16, sq // MESH_RANKS, sk if sk == 77 else sq, 8, d)
       for sq, sk, d in UNET_ATTN],
    ATTN_SHAPES, FAMILY_ATTN_SHAPES, EDIT_ATTN_SHAPES, ADDON_ATTN_SHAPES,
    SERVE_ATTN_SHAPES, TRAIN_ATTN_SHAPES)
UNET_NORM2 = [(320, 64, 64), (640, 32, 32), (1280, 16, 16), (1280, 8, 8)]
VAE_NORM2 = [(512, 64, 64), (512, 128, 128), (256, 256, 256),
             (128, 512, 512)]
# (shape, eps, silu, groups)
MESH_GN_SHAPES = (
    [((16, c // MESH_RANKS, h, w), 1e-5, True, 32 // MESH_RANKS)
     for c, h, w in UNET_NORM2]
    + [((8, c // MESH_RANKS, h, w), 1e-6, True, 32 // MESH_RANKS)
       for c, h, w in VAE_NORM2])
# (shape, silu) of the split-statistics GroupNorm: a rank's half of the
# width of each UNet GroupNorm, 32 groups, the partials of 2 ranks merged
MESH_SPLIT_GN = list(dict.fromkeys(
    ((16, c, h, w // MESH_RANKS), silu) for c, h, w, _, silu in UNET_GN))
# Phase 15's add-ons over model 2 (SD 1.x at 512², CFG batch 16), fp32 and
# bf16: IP-Adapter's image attention over 4 tokens at every level (tensor
# parallel: half the heads; spatial: half the queries) and ToMe 0.5's
# merged level 0 (tensor parallel: half the heads; spatial: the gathered
# level, every head).  The ControlNet's trunk and FreeU run each layout's
# UNet keys.
MESH_ADDON_ATTN_SHAPES = new_rows(
    [(16, sq, IP_TOKENS, 8 // MESH_RANKS, d) for sq, d in UNET_LEVELS]
    + [(16, sq // MESH_RANKS, IP_TOKENS, 8, d) for sq, d in UNET_LEVELS]
    + [(16, TOME_S, TOME_S, h, 40) for h in (8 // MESH_RANKS, 8)],
    MESH_ATTN_SHAPES)
# Phase 15's serving and out-of-memory split over data 2 (bf16): the
# served /walk job at batch 8 and the split's halves of 8 frames run the
# UNet at CFG batch 8 and the decoder at batch 4 a rank
MESH_SERVE_ATTN_SHAPES = new_rows(
    [(8, sq, sk, 8, d) for sq, sk, d in UNET_ATTN] + [(4, 4096, 4096, 1, 512)],
    ATTN_SHAPES, FAMILY_ATTN_SHAPES, EDIT_ATTN_SHAPES, ADDON_ATTN_SHAPES,
    POST_ATTN_SHAPES, SERVE_ATTN_SHAPES, TRAIN_ATTN_SHAPES,
    QUALITY_ATTN_SHAPES)
MESH_SERVE_GN_SHAPES = new_rows(
    [((b, c, h, w), eps, silu) for b, table in ((8, UNET_GN), (4, VAE_GN))
     for c, h, w, eps, silu in table],
    GN_SHAPES, FAMILY_GN_SHAPES, EDIT_GN_SHAPES, SERVE_GN_SHAPES,
    TRAIN_GN_SHAPES, QUALITY_GN_SHAPES)
# Phase 15's out-of-memory split over model 2 (bf16): the halves of the
# 8-frame dispatch run the UNet at CFG batch 8 and the decoder at batch 4
# under each layout (tensor parallel: half the heads, norm2 on half its
# channels at 16 groups; spatial: half the queries, the split GroupNorm on
# half the width; the spatial decoder whole, phase serve's keys)
MESH_SPLIT_ATTN_SHAPES = new_rows(
    [(8, sq, sk, 8 // MESH_RANKS, d) for sq, sk, d in UNET_ATTN]
    + [(8, sq // MESH_RANKS, sk if sk == 77 else sq, 8, d)
       for sq, sk, d in UNET_ATTN],
    MESH_ATTN_SHAPES, MESH_ADDON_ATTN_SHAPES, MESH_SERVE_ATTN_SHAPES)
MESH_SPLIT_GN_SHAPES = (
    [((8, c // MESH_RANKS, h, w), 1e-5, True, 32 // MESH_RANKS)
     for c, h, w in UNET_NORM2]
    + [((4, c // MESH_RANKS, h, w), 1e-6, True, 32 // MESH_RANKS)
       for c, h, w in VAE_NORM2])
MESH_SPLIT_HALF_GN = list(dict.fromkeys(
    ((8, c, h, w // MESH_RANKS), silu) for c, h, w, _, silu in UNET_GN))
# SDXL-base's UNet at 1024² and CFG batch 2, spatially sharded over model 2
# (bf16): a rank's half of the width of each GroupNorm, N·G = 64 runs of
# 20-480 KB, fewer runs than the card has SMs
MESH_SPLIT_XL_GN = list(dict.fromkeys(
    ((2, c, h, w // MESH_RANKS), silu) for c, h, w, _, silu in XL_UNET_GN))
# the sampler steps of phases addons, post and serve: pndm-25, half of
# phase 5's 50 (their checks hold at any depth: bit-equal, in turns,
# against one rank), so that the smoke stays well inside its time limit;
# phase mesh's bf16 dispatches (its walk, layouts, serving, add-ons and
# splits) run pndm-4, for the same reason (its checks compare dispatches of
# one depth)
LATER_STEPS = 25
MESH_STEPS = 4
# the mesh phase's bounds: data-parallel frames bit-equal to one rank's;
# the fp32 final latents (TF32 off, ddim-2) at tests/test_parallel.py's
# tolerances; the bf16 frames at phase quality's bf16 bounds
MESH_TP_TOL = dict(atol=2e-4, rtol=1e-3)
MESH_SPATIAL_TOL = dict(atol=3e-4, rtol=2e-3)
MESH_BF16_TOL = dict(psnr_mean=40.0, ssim_mean=0.95)
# each tensor-parallel rank's memory after load against the accounting
MESH_MEMORY_RTOL = 0.02
# seconds a mesh child may take (its process group's timeout is shorter)
MESH_CHILD_TIMEOUT = 420
# phase mesh's training over data 2 (the JAX trainers' layout): the fp32
# check's clip norm, far below the gradient's, so that every step clips;
# there the clipped elements sit near Adam's eps, which keeps a gradient
# element that the two sums' orders round apart from flipping a step of lr
MESH_TRAIN_FP32_CLIP = 1e-3
# the averaged fp32 gradient against one rank's on the same global batch
# (phase train's card-against-CPU bounds on the whole tree), and the masters
# after 2 steps against one rank's within a twentieth of lr a step (the CPU
# suite's Adam bound, tests/test_torch_training.py)
MESH_TRAIN_GRAD_TOL = dict(cosine=1.0 - 1e-4, max_err=1e-5)
MESH_TRAIN_ADAM_SHARE = 0.05
# its sides: the fp32 check's latents, the bf16 UNet's, LoRA's and LCM's
# latents, the VAE's images
MESH_TRAIN_SIDES = dict(fp32=32, latents=64, images=512)

# the trained checkpoints' frames on the card (fp32, TF32 off) against the
# CPU's: the bounds the CPU suite holds the port to against the JAX package
TRAINED_TOL = dict(max_abs=2 / 255, psnr_min=50.0, ssim_min=0.999)
# the bf16 pndm-50 dispatch of the trained checkpoint against the card's
# fp32 one: bf16 rounding through 50 steps moves some frames far (one frame
# of 8 reads 20.5 dB, on the CPU and on an H100), so the bound is on the
# means, which read 44.8 dB and 0.973 on an H100 (set at 30 dB and 0.90
# before the first reading)
TRAINED_BF16_TOL = dict(psnr_mean=40.0, ssim_mean=0.95)
# LPIPS on the card (fp32, TF32 off) against the CPU: the JAX package's
# own test tolerance (tests/test_lpips.py)
LPIPS_TOL = dict(rtol=2e-4, atol=2e-5)
# the upsampler, the safety checker's tower and head, and the FreeU filter
# in fp32 (TF32 off) on the card against the CPU; ToMe's merge and unmerge
POST_TOL = dict(atol=1e-4, rtol=1e-4)
OPS_TOL = dict(atol=1e-5, rtol=1e-5)
# multiply-adds of RealESRGAN_x4plus on one 512² frame: 23 RRDBs of 3 dense
# blocks (3·9·(64·32 + 96·32 + 128·32 + 160·32 + 192·64) a pixel each) at
# 512², conv_body and conv_first there, conv_up1 at 1024², conv_up2,
# conv_hr and conv_last at 2048²
ESRGAN_MACS = (512 * 512 * (23 * 3 * 9 * (64 * 32 + 96 * 32 + 128 * 32
                                          + 160 * 32 + 192 * 64)
                            + 9 * 64 * 64 + 9 * 3 * 64)
               + 1024 ** 2 * 9 * 64 * 64 + 2048 ** 2 * 9 * (2 * 64 * 64
                                                             + 64 * 3))
# multiply-adds of the safety checker's ViT-L/14 on one frame: 257 tokens x
# 24 layers of q, k, v, out (4·1024²) and the MLP (2·1024·4096), the
# scores and their product with v (2·257·1024), the patch embedding and the
# projection
SAFETY_MACS = (24 * 257 * (4 * 1024 ** 2 + 2 * 1024 * 4096 + 2 * 257 * 1024)
               + 256 * 14 * 14 * 3 * 1024 + 1024 * 768)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def phase_env(torch):
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    triton = importlib.util.find_spec("triton")
    print("triton", __import__("triton").__version__ if triton else "absent")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if Path(nvcc).exists():
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
        print(f"nvcc {nvcc}: {ver}")
    else:
        print("nvcc absent")
    print("PIL", bool(importlib.util.find_spec("PIL")), "cv2",
          bool(importlib.util.find_spec("cv2")), "ffmpeg",
          shutil.which("ffmpeg"))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print("gpu:", gpu_line(), "| devices:", torch.cuda.device_count())
    # the communicator abort a rank's NCCL watcher calls (parallel/mesh.py)
    import torch.distributed as dist
    nccl = getattr(dist, "ProcessGroupNCCL", None)
    print("communicator abort: ProcessGroup.abort",
          hasattr(dist.ProcessGroup, "abort"), "| ProcessGroupNCCL.abort",
          nccl is not None and hasattr(nccl, "abort"))


# Hopper instructions the kernels must contain: warpgroup MMA, TMA tensor
# loads, mbarrier syncs, register reallocation and cluster barriers
SASS_NEEDED = ("HGMMA", "UTMALDG", "SYNCS", "USETMAXREG", "UCGABAR_ARV")
# and, function by function, the backward kernels: each bf16 attention
# backward kernel on wgmma fed by TMA tensor loads, every instantiation of
# the GroupNorm backward on cluster barriers
BWD_SASS_NEEDED = {"bwd_dkdv_wgmma": ("HGMMA", "UTMALDG"),
                   "bwd_dq_wgmma": ("HGMMA", "UTMALDG"),
                   "bwd_scores_wgmma": ("HGMMA", "UTMALDG"),
                   "bwd_gemm_wgmma": ("HGMMA", "UTMALDG"),
                   "gn_bwd_kernel": ("UCGABAR_ARV",)}


def sass_functions(sass: str) -> dict:
    """``cuobjdump -sass`` output cut into {function name: its SASS}."""
    functions, name = {}, None
    for line in sass.splitlines():
        text = line.strip()
        if text.startswith("Function : "):
            name = text[len("Function : "):]
            functions[name] = []
        elif name is not None:
            functions[name].append(text)
    return {name: "\n".join(body) for name, body in functions.items()}


def phase_build():
    from stable_diffusion_videos_tpu_torch.ops import build
    t0 = time.perf_counter()
    lib = build.library()
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "ptxas.log").write_text(build.library.ptxas_log)
    for line in build.library.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "C7514" in line:
            print("  ptxas:", line.strip())
    print(f"build: nvcc {build.library.build_seconds:.1f} s, load "
          f"{time.perf_counter() - t0:.1f} s")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: sass.count(op) for op in SASS_NEEDED}
    print(f"sass: {counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"the kernels lack Hopper instructions: {counts}")
    # the backward kernels themselves, function by function
    functions = sass_functions(sass)
    for kernel, needed in BWD_SASS_NEEDED.items():
        found = {name: {op: body.count(op) for op in needed}
                 for name, body in functions.items() if kernel in name}
        for name, ops in found.items():
            print(f"sass: {kernel} {name[:60]}: {ops}")
        if not found or min(n for ops in found.values()
                            for n in ops.values()) == 0:
            raise AssertionError(f"{kernel} lacks {needed}: {found}")


def time_ms(torch, fn, warmup: int = 1, window_ms: float = 5.0) -> float:
    """Mean ms a call over back-to-back calls between two CUDA events: 5
    to 200 of them, as many as fill about window_ms (a call of tens of
    microseconds is otherwise read off a handful of launches), after
    ``warmup`` calls and one that sizes the window."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        fn()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = int(min(200, max(5, window_ms // max(start.elapsed_time(end),
                                                1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps: int) -> float:
    """Mean device ms a call over ``reps`` back-to-back calls enqueued
    behind a device sleep that outlasts their enqueueing, so the host's
    launch rate (tens of microseconds a wrapper call) does not enter."""
    return queued_times(torch, fn, reps)[0]


def queued_times(torch, fn, reps: int) -> tuple[float, float]:
    """``queued_ms``'s device ms a call, and the host µs a call took to
    enqueue them (the wrapper's own time: the queue never waits)."""
    cycles = 50_000_000
    fn()
    while True:
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e2.record()
        torch.cuda.synchronize()
        if e0.elapsed_time(e1) > host_ms:
            return e1.elapsed_time(e2) / reps, host_ms * 1e3 / reps
        cycles *= 2


def add_split(sums: dict, ms, queued, plain, library, bound, host_us):
    """One split GroupNorm row's readings added to its family's sums."""
    for key, value in (("ms", ms), ("queued", queued), ("plain", plain),
                       ("library", library), ("bound", bound),
                       ("host_us", host_us), ("rows", 1)):
        sums[key] += value


def kernel_breakdown(torch, fn, reps: int = 5) -> str:
    """Device ms a call of each kernel ``fn`` launches (torch.profiler over
    ``reps`` calls after a warm one), longest first."""
    import re

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.device_time_total > 0:
            # "void (anonymous namespace)::bwd_dq_wgmma<...>(...)" -> its name
            m = re.search(r"(\w+)[<(]", e.key.split("::", 1)[-1])
            parts.append((e.device_time_total / reps / 1e3,
                          m.group(1) if m else e.key))
    return ", ".join(f"{name} {ms:.4f}" for ms, name in sorted(parts)[::-1])


def compare(torch, name, out, ref, dtype_name) -> float:
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype_name],
                               msg=lambda m: f"{name}: {m}")
    return err


def scaled_err(out, ref) -> tuple[float, float]:
    diff, ref = out.float() - ref.float(), ref.float()
    return ((diff.abs().max() / ref.abs().max()).item(),
            (diff.norm() / ref.norm()).item())


def check_attn_scaled(name, out, q, k, v, ref, reference) -> str:
    """The scaled check on the kernel's output, and its readings of two
    planted faults (logits scaled 1.1x; the last key tile dropped), which it
    must reject: otherwise it could not see them at this shape."""
    lim = ATTN_SCALED
    ratio, rel = scaled_err(out, ref)
    if ratio > lim["max_ratio"] or rel > lim["rel_l2"]:
        raise AssertionError(f"{name}: max ratio {ratio:.3e}, rel l2 "
                             f"{rel:.3e} over {lim}")
    faults = {"logits x1.1": reference(q, k, v, 1.1 * q.shape[-1] ** -0.5)}
    kept = (k.shape[1] - 1) // 64 * 64
    if kept:
        faults["last key tile dropped"] = reference(q, k[:, :kept],
                                                    v[:, :kept])
    text = f"scaled max ratio {ratio:.3e} rel l2 {rel:.3e}"
    for fault, bad in faults.items():
        f_ratio, f_rel = scaled_err(bad, ref)
        if f_ratio <= lim["max_ratio"] and f_rel <= lim["rel_l2"]:
            raise AssertionError(f"{name}: the scaled check passes a planted "
                                 f"fault ({fault}: {f_ratio:.3e}, "
                                 f"{f_rel:.3e})")
        text += f"; {fault}: {f_ratio:.3e} {f_rel:.3e}"
    return text


def attn_bwd_faults(torch, route, q, k, v, o, do) -> list:
    """The plain backward with one planted fault each, as (fault, index of
    the gradient it changes in (dq, dk, dv), that gradient in q's dtype):
    the last key tile of ``route`` dropped from dq, its last q tile dropped
    from dk and from dv, and dS without its D_i term in dq and dk."""
    sq, d, sk = q.shape[1], q.shape[3], k.shape[1]
    scale = d ** -0.5
    bq, bk = ATTN_BWD_TILES[route]
    kk, qk = (sk - 1) // bk * bk, (sq - 1) // bq * bq
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    faults = [
        ("last key tile dropped", 0, torch.einsum(
            "bhqk,bkhd->bqhd", ds[..., :kk], kf[:, :kk]) * scale),
        ("last q tile dropped", 1, torch.einsum(
            "bhqk,bqhd->bkhd", ds[:, :, :qk], qf[:, :qk]) * scale),
        ("last q tile dropped", 2, torch.einsum(
            "bhqk,bqhd->bkhd", p[:, :, :qk], dof[:, :qk]))]
    del ds, delta
    ds = p * dp
    del p, dp
    faults += [("D_i left out", 0, torch.einsum(
                   "bhqk,bkhd->bqhd", ds, kf) * scale),
               ("D_i left out", 1, torch.einsum(
                   "bhqk,bqhd->bkhd", ds, qf) * scale)]
    return [(fault, i, g.to(q.dtype)) for fault, i, g in faults]


def check_attn_bwd_scaled(name, got, want, faults) -> str:
    """The scaled check on each of dq, dk, dv against the plain backward's,
    and its readings of the planted faults, each of which it must reject
    in the gradient the fault changes."""
    lim = ATTN_BWD_SCALED
    text = "scaled (max ratio, rel l2)"
    for t, out, ref in zip("qkv", got, want):
        ratio, rel = scaled_err(out, ref)
        if ratio > lim["max_ratio"] or rel > lim["rel_l2"]:
            raise AssertionError(f"{name} d{t}: max ratio {ratio:.3e}, rel "
                                 f"l2 {rel:.3e} over {lim}")
        text += f" d{t} {ratio:.3e} {rel:.3e}"
    for fault, i, bad in faults:
        f_ratio, f_rel = scaled_err(bad, want[i])
        if f_ratio <= lim["max_ratio"] and f_rel <= lim["rel_l2"]:
            raise AssertionError(f"{name}: the scaled check passes a planted "
                                 f"fault ({fault} in d{'qkv'[i]}: "
                                 f"{f_ratio:.3e}, {f_rel:.3e})")
        text += f"; {fault} d{'qkv'[i]}: {f_ratio:.3e} {f_rel:.3e}"
    return text


def plain_attention(torch, reference, q, k, v, scale=None):
    """The plain version over batch chunks whose fp32 scores stay within 4
    GB (SD 2.x's level 0 at CFG batch 16 would hold 27 GB at once): the
    same function on the same inputs."""
    b, sq, h, _ = q.shape
    step = max(1, int(4e9 // (4 * h * sq * k.shape[1])))
    if step >= b:
        return reference(q, k, v, scale)
    return torch.cat([
        reference(q[i:i + step], k[i:i + step], v[i:i + step], scale)
        for i in range(0, b, step)])


def attn_bound(b, sq, sk, h, d, elem_bytes) -> tuple[float, str]:
    """Least time (ms) for one attention call and what sets it: q·kᵀ and
    p·v are 4·B·H·Sq·Sk·D operations at the type's peak; q, k, v read once
    and o written once."""
    ops = 4.0 * b * h * sq * sk * d
    nbytes = elem_bytes * b * h * d * (2 * sq + 2 * sk)
    return bound_ms(ops, nbytes, PEAK_OPS[elem_bytes])


def gn_bound(shape, silu, elem_bytes) -> tuple[float, str]:
    """Least time (ms) for one GroupNorm(+SiLU) call: x read once, y written
    once, scale and bias (fp32) read once; about 5 operations an element
    (Welford update, one multiply-add) plus 4 for SiLU, on fp32 units."""
    n = float(np.prod(shape))
    nbytes = 2 * elem_bytes * n + 2 * 4 * shape[1]
    return bound_ms((5 + 4 * silu) * n, nbytes, PEAK_OPS[4])


def attn_bwd_bound(b, sq, sk, h, d, elem_bytes) -> tuple[float, str]:
    """Least time (ms) for one attention backward: 10·Sq·Sk·D operations
    a (b, h) (five products of the scores' size: q·kᵀ, do·vᵀ, Pᵀ·do, dSᵀ·q,
    dS·k) at the type's peak; q, o, do, dq (Sq rows) and k, v, dk, dv (Sk
    rows) moved once."""
    ops = 10.0 * b * h * sq * sk * d
    nbytes = elem_bytes * b * h * d * (4 * sq + 4 * sk)
    return bound_ms(ops, nbytes, PEAK_OPS[elem_bytes])


def gn_bwd_bound(shape, silu, elem_bytes) -> tuple[float, str]:
    """Least time (ms) for one GroupNorm(+SiLU) backward: x and dy read
    once, dx written once, the weights (fp32) read and their gradients
    written once; about 10 operations an element (the statistics again, x̂,
    two sums, dx) plus 8 for SiLU's derivative, on fp32 units."""
    n = float(np.prod(shape))
    nbytes = 3 * elem_bytes * n + 4 * 4 * shape[1]
    return bound_ms((10 + 8 * silu) * n, nbytes, PEAK_OPS[4])


def bound_ms(ops, nbytes, peak_ops) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


# the fp32 GroupNorm-backward row whose dγ and dβ sum 262144 terms a
# channel (2 blocks of a cluster each), on draws of its own: each seed's
# inputs as phase 3 draws that row's, held against the plain backward in
# fp64 at phase 3's fp32 tolerance
GN_BWD_SEED_ROW = ((1, 256, 512, 512), 1e-6, True)
GN_BWD_SEEDS = (171, 172, 173)


def gn_bwd_fresh_seeds(torch, check: bool = True) -> list:
    """The fp32 row ``GN_BWD_SEED_ROW`` of the GroupNorm backward on each
    of ``GN_BWD_SEEDS``: per seed and tensor (dx, dscale, dbias) the max
    abs error against fp64 and its largest share of the bound (atol + rtol
    · |want|, phase 3's fp32 ``TOL``); -> the readings.  With ``check`` a
    share above 1 fails."""
    from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
        groupnorm_backward_reference, groupnorm_silu_backward)
    dev, tol = torch.device("cuda"), TOL["float32"]
    (shape, eps, silu), out = GN_BWD_SEED_ROW, []
    for seed in GN_BWD_SEEDS:
        rg = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(shape, device=dev, generator=rg) * 2 + 0.5
        dy = torch.randn(shape, device=dev, generator=rg)
        scale, bias = (torch.randn(shape[1], device=dev, generator=rg)
                       for _ in range(2))
        args = (x, scale, bias, dy, 32, eps, silu)
        got = groupnorm_silu_backward(*args)
        want = groupnorm_backward_reference(
            *(t.double() for t in args[:4]), *args[4:])
        for name, g_, w in zip(("dx", "dscale", "dbias"), got, want):
            diff = (g_.double() - w.double()).abs()
            share = (diff / (tol["atol"] + tol["rtol"] * w.double().abs()))
            out.append(dict(seed=seed, tensor=name,
                            max_abs_err=diff.max().item(),
                            share_of_bound=share.max().item()))
        del x, dy, got, want
    torch.cuda.empty_cache()
    for r in out:
        print(f"groupnorm bwd float32 {shape} eps={eps} silu={silu} seed "
              f"{r['seed']} {r['tensor']}: max_abs_err {r['max_abs_err']:.3e}"
              f", largest share of the bound {r['share_of_bound']:.3f} "
              f"(atol {tol['atol']}, rtol {tol['rtol']}, against fp64)")
    if check and max(r["share_of_bound"] for r in out) > 1.0:
        raise AssertionError(f"the fp32 GroupNorm backward exceeds its "
                             f"bound on a fresh seed: {out}")
    return out


def phase_kernels(torch):
    """Each kernel against its plain version, and its time beside the plain
    version's, one PyTorch library call's (the yardstick; the port never
    calls it) and the bound."""
    import torch.nn.functional as F

    from stable_diffusion_videos_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward,
        flash_attention_backward_reference, flash_attention_reference,
        flash_attention_with_lse)
    from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
        fused_groupnorm_silu, groupnorm_apply, groupnorm_apply_reference,
        groupnorm_backward_reference, groupnorm_partials,
        groupnorm_partials_reference, groupnorm_reference,
        groupnorm_silu_backward)
    from stable_diffusion_videos_tpu_torch.ops import build
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # the mesh phase's rows draw from their own generator, so the earlier
    # rows keep the inputs they have always had
    g_mesh = torch.Generator(device=dev).manual_seed(14)
    mesh_rows = set(MESH_ATTN_SHAPES) | {s_ for s_, *_ in MESH_GN_SHAPES}
    # and the mesh's add-on and serving rows (PR 16) from theirs
    g_addon = torch.Generator(device=dev).manual_seed(16)
    # and the mesh's fp32 training rows from theirs
    g_train = torch.Generator(device=dev).manual_seed(15)
    # and the model-axis split's rows from theirs
    g_split = torch.Generator(device=dev).manual_seed(17)
    # and the SDXL half-slab rows of the split GroupNorm from theirs
    g_xl = torch.Generator(device=dev).manual_seed(18)
    lib = build.library()
    summary = {name: dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                          bound_ms=0.0, bound_by={}, rows={})
               for name in ("flash_attention", "groupnorm_silu",
                            "flash_attention_bwd", "groupnorm_silu_bwd",
                            "groupnorm_stats", "groupnorm_apply")}
    # the backward rows' and the split GroupNorm's device time, queued
    # behind a device sleep
    queued_sum = {"flash_attention_bwd": 0.0, "groupnorm_silu_bwd": 0.0,
                  "groupnorm_stats": 0.0, "groupnorm_apply": 0.0}
    # the same sums over the rows phase 8's families and phase 9's edit
    # paths add
    groups = {
        group: ({(*s, torch.bfloat16) for s in attn}
                | {(*c, torch.bfloat16) for c in gn},
                {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                            bound_ms=0.0) for name in summary})
        for group, attn, gn in (
            ("families", FAMILY_ATTN_SHAPES, FAMILY_GN_SHAPES),
            ("edit", EDIT_ATTN_SHAPES, EDIT_GN_SHAPES),
            ("addons", ADDON_ATTN_SHAPES, []),
            ("post", POST_ATTN_SHAPES, []),
            ("serve", SERVE_ATTN_SHAPES, SERVE_GN_SHAPES),
            ("quality", QUALITY_ATTN_SHAPES, QUALITY_GN_SHAPES),
            ("mesh", MESH_ATTN_SHAPES + MESH_ADDON_ATTN_SHAPES
             + MESH_SERVE_ATTN_SHAPES + MESH_SPLIT_ATTN_SHAPES,
             [((shape, eps, silu, g)) for shape, eps, silu, g
              in MESH_GN_SHAPES + MESH_SPLIT_GN_SHAPES]
             + [(*c, 32) for c in MESH_SERVE_GN_SHAPES]))}

    def record(name, key, text, dt, err, ms, pms, lms, bound):
        b_ms, b_by = bound
        print(f"{text}: max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
              f"{pms:.4f} ms library {lms:.4f} ms bound {b_ms:.4f} ms "
              f"({b_by}) share of bound {b_ms / ms:.3f}")
        summary[name]["rows"][(key, dt)] = ms
        s = summary[name]
        s["err"] = max(s["err"], err)
        if dt == torch.bfloat16:
            s["ms"] += ms
            s["plain_ms"] += pms
            s["library_ms"] += lms
            s["bound_ms"] += b_ms
            s["bound_by"][b_by] = s["bound_by"].get(b_by, 0.0) + b_ms
            for keys, sums in groups.values():
                if not name.endswith("_bwd") and (*key, dt) in keys:
                    for field, value in (("ms", ms), ("plain_ms", pms),
                                         ("library_ms", lms),
                                         ("bound_ms", b_ms)):
                        sums[name][field] += value

    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        eb = torch.finfo(dt).bits // 8
        # the host seconds of each part of the rows, so that a part that
        # grows the phase shows
        spent, t_part = {}, time.perf_counter()

        def part_done(part):
            nonlocal t_part
            now = time.perf_counter()
            spent[part] = now - t_part
            t_part = now
        # the families', the edit paths' and the add-ons' rows in the walks'
        # dtype only
        shapes = ATTN_SHAPES + (FAMILY_ATTN_SHAPES + EDIT_ATTN_SHAPES
                                + ADDON_ATTN_SHAPES + POST_ATTN_SHAPES
                                + SERVE_ATTN_SHAPES + TRAIN_ATTN_SHAPES
                                if dt == torch.bfloat16
                                else TRAIN_FP32_ATTN_SHAPES) \
            + QUALITY_ATTN_SHAPES + MESH_ATTN_SHAPES
        train_rows = (MESH_TRAIN_FP32_ATTN_SHAPES if dt == torch.float32
                      else [])
        # PR 16's rows last, from their own generator, each once (ToMe's
        # bf16 level-0 row is phase post's)
        new_mesh_rows = [r for r in MESH_ADDON_ATTN_SHAPES + (
            MESH_SERVE_ATTN_SHAPES if dt == torch.bfloat16 else [])
            if r not in shapes]
        # then the model-axis split's, from theirs
        split_rows = MESH_SPLIT_ATTN_SHAPES if dt == torch.bfloat16 else []
        for b, sq, sk, h, d, rg in (
                [(*r, None) for r in shapes + train_rows]
                + [(*r, g_addon) for r in new_mesh_rows]
                + [(*r, g_split) for r in split_rows]):
            rg = rg or (g_mesh if (b, sq, sk, h, d) in mesh_rows
                        else g_train if (b, sq, sk, h, d) in train_rows
                        else g)
            q = torch.randn(b, sq, h, d, device=dev, generator=rg).to(dt)
            k = torch.randn(b, sk, h, d, device=dev, generator=rg).to(dt)
            v = torch.randn(b, sk, h, d, device=dev, generator=rg).to(dt)
            name = f"attn {dn} B={b} Sq={sq} Sk={sk} H={h} D={d}"
            if dt == torch.bfloat16:
                depth = lib.sdv_flash_attention_depth(d)
                if d == 64 and depth != 64:
                    raise AssertionError(f"{name} runs at depth {depth}")
                name += f" (depth {depth})"

            def plain(q_, k_, v_, scale=None):
                return plain_attention(torch, flash_attention_reference,
                                       q_, k_, v_, scale)
            out = flash_attention(q, k, v)
            ref = plain(q, k, v)
            err = compare(torch, name, out, ref, dn)
            scaled = ("" if dt != torch.bfloat16 else "; " + check_attn_scaled(
                name, out, q, k, v, ref, plain))
            del out, ref
            ms = time_ms(torch, lambda: flash_attention(q, k, v))
            pms = time_ms(torch, lambda: plain(q, k, v))
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh))
            del qh, kh, vh
            if dt == torch.bfloat16 and d == 64:
                # against the work of the depth these heads ran at before
                # (inputs zero-padded to 80 columns), in turns 64, 80, 80,
                # 64, least of each, on the device clock
                q8, k8, v8 = (F.pad(t, (0, 16)) for t in (q, k, v))
                reps = int(min(100, max(5, 20.0 / ms)))
                turns = {64: lambda: flash_attention(q, k, v),
                         80: lambda: flash_attention(q8, k8, v8)}
                read = {64: [], 80: []}
                for depth in (64, 80, 80, 64):
                    read[depth].append(queued_ms(torch, turns[depth], reps))
                scaled += (f"; queued in turns: depth 64 {min(read[64]):.4f}"
                           f" ms, depth 80 {min(read[80]):.4f} ms")
                del q8, k8, v8, turns
            record("flash_attention", (b, sq, sk, h, d), name + scaled, dt,
                   err, ms, pms, lms, attn_bound(b, sq, sk, h, d, eb))
            del q, k, v
        if dt == torch.bfloat16:
            q = torch.zeros(16, 4096, 8, 40, device=dev, dtype=dt)
            us = lib.sdv_tensor_map_encode_us(q.data_ptr(), 16, 4096, 8, 40,
                                              1000)
            if us < 0:
                raise AssertionError("tensor map encoding failed")
            print(f"host: a bf16 attention call encodes its three TMA "
                  f"tensor maps in {us:.2f} us")
            del q
        part_done("attention")
        for shape, eps, silu, n_groups, w_dt, rg in (
                [(*c, 32, dt, g) for c in GN_SHAPES]
                + [(*c, 32, dt, g) for c in (
                    FAMILY_GN_SHAPES + EDIT_GN_SHAPES + SERVE_GN_SHAPES
                    + TRAIN_GN_SHAPES if dt == torch.bfloat16
                    else TRAIN_FP32_GN_SHAPES)]
                + [(*c, 32, dt, g) for c in QUALITY_GN_SHAPES]
                + [(*c, dt, g_mesh) for c in MESH_GN_SHAPES]
                + [(*c, 32, torch.float32, g) for c in GN_EXTRA]
                + [(*c, 32, dt, g_train) for c in (
                    MESH_TRAIN_FP32_GN_SHAPES if dt == torch.float32
                    else [])]
                + [(*c, 32, dt, g_addon) for c in (
                    MESH_SERVE_GN_SHAPES if dt == torch.bfloat16
                    else [])]
                + [(*c, dt, g_split) for c in (
                    MESH_SPLIT_GN_SHAPES if dt == torch.bfloat16
                    else [])]):
            x = (torch.randn(shape, device=dev, generator=rg) * 2
                 + 0.5).to(dt)
            scale = torch.randn(shape[1], device=dev, generator=rg).to(w_dt)
            bias = torch.randn(shape[1], device=dev, generator=rg).to(w_dt)
            name = (f"groupnorm {dn} {shape} eps={eps} silu={silu} weights "
                    f"{str(w_dt).split('.')[1]}"
                    + (f" groups={n_groups}" if n_groups != 32 else ""))
            args = (x, scale, bias, n_groups, eps, silu)
            err = compare(torch, name, fused_groupnorm_silu(*args),
                          groupnorm_reference(*args), dn)
            ms = time_ms(torch, lambda: fused_groupnorm_silu(*args))
            pms = time_ms(torch, lambda: groupnorm_reference(*args))
            # the library call takes its weights in x's dtype
            sx, bx = scale.to(dt), bias.to(dt)
            lms = time_ms(torch, (lambda: F.silu(F.group_norm(
                x, n_groups, sx, bx, eps))) if silu else (
                    lambda: F.group_norm(x, n_groups, sx, bx, eps)))
            group_mb = np.prod(shape[1:]) // n_groups * eb / 1e6
            record("groupnorm_silu", (shape, eps, silu) if n_groups == 32
                   else (shape, eps, silu, n_groups),
                   f"{name} ({group_mb:.1f} MB a group)", dt, err, ms, pms,
                   lms, gn_bound(shape, silu, eb))
            del x
        part_done("groupnorm")
        # the split-statistics GroupNorm at the spatial layout's keys: the
        # partials pass against its plain version and, as its library
        # yardstick, torch.var_mean over the grouped view; the apply pass
        # (two ranks' partials merged) against its plain version (no one
        # PyTorch call computes it: library time 0, "none" in the line);
        # each twice, bit-equal.  The SD 1.x rows' and the SDXL rows' bf16
        # sums each on a line of their own, with the wrappers' host µs a
        # call (enqueueing behind a device sleep)
        split_sums = {fam: {k: dict(ms=0.0, queued=0.0, plain=0.0,
                                    library=0.0, bound=0.0, host_us=0.0,
                                    rows=0)
                            for k in ("partials", "apply")}
                      for fam in ("SD 1.x", "SDXL")}
        for shape, silu, rg in (
                [(*c, g_mesh) for c in MESH_SPLIT_GN]
                + [(*c, g_split) for c in (
                    MESH_SPLIT_HALF_GN if dt == torch.bfloat16 else [])]
                + [(*c, g_xl) for c in (
                    MESH_SPLIT_XL_GN if dt == torch.bfloat16 else [])]):
            fam = split_sums["SDXL" if shape[0] == 2 else "SD 1.x"]
            x = (torch.randn(shape, device=dev, generator=rg) * 2
                 + 0.5).to(dt)
            x2 = (torch.randn(shape, device=dev, generator=rg) * 3
                  - 1).to(dt)
            scale, bias = (torch.randn(shape[1], device=dev,
                                       generator=rg).to(dt)
                           for _ in range(2))
            name = f"groupnorm split {dn} {shape} silu={silu}"
            got = groupnorm_partials(x, 32)
            err = compare(torch, f"{name} partials", got,
                          groupnorm_partials_reference(x, 32), "float32")
            if not torch.equal(got, groupnorm_partials(x, 32)):
                raise AssertionError(f"{name}: two partials calls differ")
            ms = time_ms(torch, lambda: groupnorm_partials(x, 32))
            # the device's own time, calls queued behind a device sleep so
            # that the wrapper's host time does not enter
            dms, host_us = queued_times(
                torch, lambda: groupnorm_partials(x, 32),
                int(min(100, max(5, 20.0 / ms))))
            if dt == torch.bfloat16:
                queued_sum["groupnorm_stats"] += dms
            pms = time_ms(torch, lambda: groupnorm_partials_reference(x, 32))
            xg = x.view(shape[0], 32, -1)
            lms = time_ms(torch, lambda: torch.var_mean(xg, dim=-1))
            n = float(np.prod(shape))
            bound = bound_ms(5 * n, eb * n + shape[0] * 32 * 12, PEAK_OPS[4])
            record("groupnorm_stats", (shape, silu),
                   f"{name} partials (library: torch.var_mean; device "
                   f"(queued) {dms:.4f} ms; host {host_us:.1f} us a call)",
                   dt, err, ms, pms, lms, bound)
            if dt == torch.bfloat16:
                add_split(fam["partials"], ms, dms, pms, lms, bound[0],
                          host_us)
            parts = torch.stack([got, groupnorm_partials(x2, 32)])
            args = (x, scale, bias, parts, 32, 1e-5, silu)
            got = groupnorm_apply(*args)
            err = compare(torch, f"{name} apply", got,
                          groupnorm_apply_reference(*args), dn)
            if not torch.equal(got, groupnorm_apply(*args)):
                raise AssertionError(f"{name}: two apply calls differ")
            ms = time_ms(torch, lambda: groupnorm_apply(*args))
            dms, host_us = queued_times(
                torch, lambda: groupnorm_apply(*args),
                int(min(100, max(5, 20.0 / ms))))
            if dt == torch.bfloat16:
                queued_sum["groupnorm_apply"] += dms
            pms = time_ms(torch, lambda: groupnorm_apply_reference(*args))
            bound = gn_bound(shape, silu, eb)
            record("groupnorm_apply", (shape, silu),
                   f"{name} apply, 2 ranks' partials (library: none; device "
                   f"(queued) {dms:.4f} ms; host {host_us:.1f} us a call)",
                   dt, err, ms, pms, 0.0, bound)
            if dt == torch.bfloat16:
                add_split(fam["apply"], ms, dms, pms, 0.0, bound[0], host_us)
            del x, x2, xg, parts, got
        if dt == torch.bfloat16:
            for fam, kernels in split_sums.items():
                for kernel, f in kernels.items():
                    print(f"groupnorm split {kernel}: the {f['rows']} "
                          f"{fam} bf16 rows sum to {f['ms']:.4f} ms back to "
                          f"back, {f['queued']:.4f} ms on the device "
                          f"(queued), plain {f['plain']:.4f} ms, library "
                          f"{f['library']:.4f} ms, bound {f['bound']:.4f} "
                          f"ms; host {f['host_us'] / f['rows']:.2f} us a "
                          f"call (mean)")
        torch.cuda.empty_cache()
        part_done("split groupnorm")
        # the backward kernels against the plain backwards, given the
        # forward's saved log-sum-exp as a gradient's backward is; the
        # library is autograd through scaled_dot_product_attention, or
        # group_norm+silu
        for (b, sq, sk, h, d), rg in (
                [(s_, g) for s_ in BWD_ATTN_SHAPES + (
                    TRAIN_FP32_ATTN_SHAPES if dt == torch.float32 else [])]
                + [(s_, g_train) for s_ in train_rows]):
            q, k, v = (torch.randn(b, s_, h, d, device=dev,
                                   generator=rg).to(dt)
                       for s_ in (sq, sk, sk))
            do = torch.randn(b, sq, h, d, device=dev, generator=rg).to(dt)
            o, lse = flash_attention_with_lse(q, k, v)
            name = f"attn bwd {dn} B={b} Sq={sq} Sk={sk} H={h} D={d}"

            def bwd():
                return flash_attention_backward(q, k, v, o, do, None, lse)
            routes = flash_attention_backward.by_route.copy()
            got = bwd()
            ran = sorted((flash_attention_backward.by_route - routes).keys())
            if (dt == torch.bfloat16) != bool(
                    {"fused", "materialised"} & set(ran)):
                raise AssertionError(f"{name} ran on {ran}")
            name += f" (route {'+'.join(ran)})"
            want = flash_attention_backward_reference(q, k, v, o, do)
            err = max(compare(torch, f"{name} d{t}", out, ref, dn)
                      for t, out, ref in zip("qkv", got, want))
            scaled = ""
            if dt == torch.bfloat16:
                route = "fused" if "fused" in ran else "materialised"
                scaled = "; " + check_attn_bwd_scaled(
                    name, got, want,
                    attn_bwd_faults(torch, route, q, k, v, o, do))
            del got
            if dt == torch.bfloat16:
                # the FMA path at the same shape, checked the same way and
                # timed in turns (tensor cores, FMA, FMA, tensor cores),
                # least of each
                lib.sdv_attention_backward_tensor_cores(0)
                try:
                    fma = bwd()
                    err = max(err, *(compare(torch, f"{name} d{t} (FMA "
                                             f"path)", out, ref, dn)
                                     for t, out, ref in zip("qkv", fma,
                                                            want)))
                    scaled += "; FMA path " + check_attn_bwd_scaled(
                        f"{name} (FMA path)", fma, want, [])
                    del fma
                    read = {1: [], 0: []}
                    for on in (1, 0, 0, 1):
                        lib.sdv_attention_backward_tensor_cores(on)
                        read[on].append(time_ms(torch, bwd))
                finally:
                    lib.sdv_attention_backward_tensor_cores(1)
                ms = min(read[1])
                scaled += (f"; in turns: tensor cores {ms:.4f} ms, FMA path "
                           f"{min(read[0]):.4f} ms")
            else:
                ms = time_ms(torch, bwd)
            # the device's own time, calls queued behind a device sleep so
            # that the wrapper's host time does not enter
            dms = queued_ms(torch, bwd, int(min(100, max(5, 20.0 / ms))))
            scaled += f"; device (queued) {dms:.4f} ms"
            if dt == torch.bfloat16:
                queued_sum["flash_attention_bwd"] += dms
                scaled += (f"; kernels (device ms a call): "
                           f"{kernel_breakdown(torch, bwd)}")
            del want
            pms = time_ms(torch, lambda: flash_attention_backward_reference(
                q, k, v, o, do))
            qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            doh = do.transpose(1, 2).contiguous()
            lms = time_ms(torch, lambda: torch.autograd.grad(
                oh, (qh, kh, vh), doh, retain_graph=True))
            record("flash_attention_bwd", (b, sq, sk, h, d), name + scaled,
                   dt, err, ms, pms, lms, attn_bwd_bound(b, sq, sk, h, d, eb))
            del q, k, v, do, o, lse, qh, kh, vh, oh, doh
        for (shape, eps, silu), rg in (
                [(c, g) for c in BWD_GN_SHAPES + (
                    TRAIN_FP32_GN_SHAPES if dt == torch.float32 else [])]
                + [(c, g_train) for c in (MESH_TRAIN_FP32_GN_SHAPES
                                          if dt == torch.float32 else [])]):
            x = (torch.randn(shape, device=dev, generator=rg) * 2
                 + 0.5).to(dt)
            dy = torch.randn(shape, device=dev, generator=rg).to(dt)
            scale, bias = (torch.randn(shape[1], device=dev,
                                       generator=rg).to(dt)
                           for _ in range(2))
            name = (f"groupnorm bwd {dn} {shape} eps={eps} silu={silu} "
                    f"weights {dn}")
            args = (x, scale, bias, dy, 32, eps, silu)
            before = lib.sdv_groupnorm_backward_launches()
            got = groupnorm_silu_backward(*args)
            n_launch = lib.sdv_groupnorm_backward_launches() - before
            if n_launch != 2:
                raise AssertionError(f"{name}: {n_launch} kernel launches, "
                                     f"not 2")
            # fp32 rows against the plain backward in fp64: dγ and dβ sum up
            # to 65536 terms a channel, which an fp32 plain version rounds
            # in an order of its own
            ref_args = args if dt == torch.bfloat16 else (
                *(t.double() for t in args[:4]), *args[4:])
            err = max(compare(torch, f"{name} {t}", g_, want, dn)
                      for t, g_, want in zip(
                          ("dx", "dscale", "dbias"), got,
                          groupnorm_backward_reference(*ref_args)))
            del got
            ms = time_ms(torch, lambda: groupnorm_silu_backward(*args))
            dms = queued_ms(torch, lambda: groupnorm_silu_backward(*args),
                            int(min(100, max(5, 20.0 / ms))))
            if dt == torch.bfloat16:
                queued_sum["groupnorm_silu_bwd"] += dms
                kernels = kernel_breakdown(
                    torch, lambda: groupnorm_silu_backward(*args))
                name += f" (kernels, device ms a call: {kernels})"
            pms = time_ms(torch, lambda: groupnorm_backward_reference(*args))
            leaves = [t.detach().requires_grad_(True)
                      for t in (x, scale, bias)]
            y = F.group_norm(leaves[0], 32, leaves[1], leaves[2], eps)
            y = F.silu(y) if silu else y
            lms = time_ms(torch, lambda: torch.autograd.grad(
                y, leaves, dy, retain_graph=True))
            group_mb = np.prod(shape[1:]) // 32 * eb / 1e6
            record("groupnorm_silu_bwd", (shape, eps, silu),
                   f"{name} ({group_mb:.1f} MB a group, 2 launches; device "
                   f"(queued) {dms:.4f} ms)", dt, err, ms, pms, lms,
                   gn_bwd_bound(shape, silu, eb))
            del x, dy, leaves, y
        torch.cuda.empty_cache()
        if dt == torch.float32:
            gn_bwd_fresh_seeds(torch)
        part_done("backward")
        print(f"kernels {dn}: host seconds by part: " + ", ".join(
            f"{k} {v:.1f}" for k, v in spent.items()))
    for name, total in queued_sum.items():
        summary[name]["queued_ms"] = total
        print(f"{name}: the bf16 rows' device time (queued) sums to "
              f"{total:.4f} ms, against {summary[name]['ms']:.4f} ms "
              f"back to back")
    for group, (_, sums) in groups.items():
        for name, f in sums.items():
            if not f["ms"]:
                continue  # the group has no rows of this kernel
            print(f"{name}: the {group} bf16 rows sum to kernel "
                  f"{f['ms']:.4f} ms, plain {f['plain_ms']:.4f} ms, library "
                  f"{f['library_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms")
    return summary


def synth_value(name: str, shape) -> np.ndarray:
    """The golden's weight rule (tests/test_full_geometry.py): per-key
    CRC-seeded, norm scales near 1, everything else ~N(0, 0.1)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    v = rng.standard_normal(shape).astype(np.float32)
    if name.endswith(".weight") and len(shape) == 1:
        return 1.0 + 0.1 * v
    return 0.1 * v


GOLDEN = ROOT / "tests" / "goldens" / "sd1_full_geometry.npz"


def golden_weights() -> dict:
    """The golden's UNet and VAE weights by its rule, drawn on the host:
    {manifest key: state dict of numpy arrays}."""
    gold = np.load(GOLDEN, allow_pickle=False)
    return {key: {k: synth_value(k, tuple(s))
                  for k, s in json.loads(str(gold[key])).items()}
            for key in ("unet_shapes", "vae_shapes")}


#: processes the phases start to run beside their own work; ``main`` stops
#: any still running when it ends
BACKGROUND: list = []


def start_background(cmd: list, **kw) -> subprocess.Popen:
    """``subprocess.Popen(cmd, **kw)``, recorded in ``BACKGROUND``."""
    proc = subprocess.Popen(cmd, **kw)
    BACKGROUND.append(proc)
    return proc


def in_background(fn):
    """Start ``fn()`` on a daemon thread; -> a function that waits for it
    and returns its result (or raises what it raised)."""
    import threading
    box = {}

    def target():
        try:
            box["value"] = fn()
        except Exception as e:  # handed to the caller of wait()
            box["error"] = e
    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]
    return wait


def phase_golden(torch, weights: Optional[dict] = None):
    """``weights``: ``golden_weights()`` when drawn already."""
    from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                               UNetConfig)
    from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                              VAEConfig)
    from stable_diffusion_videos_tpu_torch.models.weights import \
        load_state_dict
    gold = np.load(GOLDEN, allow_pickle=False)
    dev = torch.device("cuda")
    weights = weights or golden_weights()

    def build(cls, cfg, manifest_key):
        with torch.device("meta"):
            mod = cls(cfg)
        sd = weights.pop(manifest_key)
        return load_state_dict(mod, sd, torch.float32).to(dev).eval()

    rng = np.random.default_rng(2024)
    lat = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 768)).astype(np.float32) * 0.3
    with torch.no_grad():
        unet = build(UNet2DCondition, UNetConfig.sd_v1(), "unet_shapes")
        sample = torch.tensor(lat.transpose(0, 3, 1, 2), device=dev)
        eps = unet(sample.repeat(2, 1, 1, 1),
                   torch.tensor([500.0, 500.0], device=dev),
                   torch.tensor(ctx, device=dev))
        eps = eps.cpu().numpy().transpose(0, 2, 3, 1)
        del unet
        # one CFG + DDIM update in the golden's numpy math
        e = eps[0:1] + 7.5 * (eps[1:2] - eps[0:1])
        x0 = (lat - np.sqrt(1 - 0.2) * e) / np.sqrt(0.2)
        stepped = (np.sqrt(0.4) * x0 + np.sqrt(1 - 0.4) * e).astype(np.float32)
        vae = build(AutoencoderKL, VAEConfig.sd_v1(), "vae_shapes")
        dec = vae.decode(torch.tensor(stepped.transpose(0, 3, 1, 2),
                                      device=dev))
        dec = dec.cpu().numpy().transpose(0, 2, 3, 1)
        # the encoder's input of the golden (tests/test_full_geometry.py):
        # tanh of its own stepped latents, upsampled 8x to 256², 3 channels
        image = np.tanh(gold["stepped"].repeat(2, axis=1).repeat(2, axis=2)
                        [..., :3].repeat(4, axis=1).repeat(4, axis=2))
        mean, logvar = (m.cpu().numpy().transpose(0, 2, 3, 1)
                        for m in vae.encode(torch.tensor(
                            image.transpose(0, 3, 1, 2), device=dev)))
        del vae
    torch.cuda.empty_cache()
    for name, got, atol, rtol in (("eps", eps, 2e-3, 2e-3),
                                  ("stepped", stepped, 2e-2, 2e-3),
                                  ("dec", dec, 2e-3, 2e-3),
                                  ("mean", mean, 2e-3, 2e-3),
                                  ("logvar", logvar, 2e-3, 2e-3)):
        err = float(np.abs(got - gold[name]).max())
        np.testing.assert_allclose(got, gold[name], atol=atol, rtol=rtol,
                                   err_msg=f"golden {name}")
        print(f"golden {name} {got.shape}: max_abs_err {err:.3e} "
              f"(atol {atol}, rtol {rtol})")


def png_size(path: Path) -> tuple[int, int]:
    head = path.read_bytes()[:24]
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def sd1_bundle(torch):
    """The random bf16 SD 1.x bundle that phases 5-7 drive, with the TAESD
    decoder at its published geometry, drawn on the card (a seeded
    generator there, in state-dict order, N(0, 0.02))."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    t0 = time.perf_counter()
    models = SDModels.random("sd1", seed=1, dtype=torch.bfloat16,
                             taesd=True, device=torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"random SD 1.x bundle built in {time.perf_counter() - t0:.1f} s")
    return models


def counted_run(torch, label: str, run, backward: bool = False,
                split: bool = False, keys: Optional[list] = None):
    """Call ``run()`` with every launch counter and plain-version counter
    set to 0 just before, read them just after, and fail unless both
    forward kernels launched (with ``backward`` both backward kernels too,
    with ``split`` both split-statistics GroupNorm kernels), no plain
    version ran, and phase 3 checks every (shape, dtype) key launched.
    ``keys``: a list that receives (kernel, key, launches) of the run.
    -> ({kernel: launches}, wall seconds)."""
    from stable_diffusion_videos_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward,
        flash_attention_backward_reference, flash_attention_reference)
    from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
        fused_groupnorm_silu, groupnorm_apply, groupnorm_apply_reference,
        groupnorm_backward_reference, groupnorm_partials,
        groupnorm_partials_reference, groupnorm_reference,
        groupnorm_silu_backward)
    counters = (flash_attention, fused_groupnorm_silu,
                flash_attention_backward, groupnorm_silu_backward,
                groupnorm_partials, groupnorm_apply)
    plains = (flash_attention_reference, groupnorm_reference,
              flash_attention_backward_reference,
              groupnorm_backward_reference, groupnorm_partials_reference,
              groupnorm_apply_reference)
    for f in counters:
        f.launches = 0
        f.by_shape.clear()
    for f in plains:
        f.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    by_shape = {f.__name__: dict(f.by_shape) for f in counters}
    plain_calls = {f.__name__: f.calls for f in plains}
    print(f"{label}: launches {launches}; plain calls {plain_calls}")
    for name, counts in by_shape.items():
        for key, n in sorted(counts.items(), key=str):
            print(f"{label}: {name} {key}: {n} launches")
    # the spatially sharded UNet normalises through the split kernels alone
    required = (counters[:4] if backward
                else (counters[0],) + counters[4:] if split
                else counters[:2])
    if (min(f.launches for f in required) <= 0
            or max(plain_calls.values()) != 0):
        raise AssertionError(f"{label} did not run on the kernels alone")
    if keys is not None:
        keys.extend((name, k, n) for name, counts in by_shape.items()
                    for k, n in counts.items())
    unchecked = unchecked_keys(torch, by_shape)
    if unchecked:
        raise AssertionError(f"phase 3 does not check the launches of "
                             f"{label} at {unchecked}")
    return launches, seconds


def checked_keys(torch) -> dict:
    """{kernel wrapper: the launch keys phase 3 checks}, in the wrappers'
    ``by_shape`` form."""
    bf16, fp32 = torch.bfloat16, torch.float32
    fp32_attn = {(*s, fp32) for s in TRAIN_FP32_ATTN_SHAPES
                 + MESH_TRAIN_FP32_ATTN_SHAPES}
    fp32_gn = {(*c, fp32, fp32, 32) for c in TRAIN_FP32_GN_SHAPES
               + MESH_TRAIN_FP32_GN_SHAPES}
    both = (bf16, fp32)
    return {
        "flash_attention": {(*s, bf16) for s in ATTN_SHAPES
                            + FAMILY_ATTN_SHAPES + EDIT_ATTN_SHAPES
                            + ADDON_ATTN_SHAPES + POST_ATTN_SHAPES
                            + SERVE_ATTN_SHAPES + TRAIN_ATTN_SHAPES
                            + QUALITY_ATTN_SHAPES}
        | fp32_attn | {(*s, fp32) for s in QUALITY_ATTN_SHAPES
                       + ATTN_SHAPES}
        | {(*s, dt) for s in MESH_ATTN_SHAPES + MESH_ADDON_ATTN_SHAPES
           for dt in both}
        | {(*s, bf16) for s in MESH_SERVE_ATTN_SHAPES
           + MESH_SPLIT_ATTN_SHAPES},
        "fused_groupnorm_silu": {(*c, bf16, bf16, 32) for c in GN_SHAPES
                                 + FAMILY_GN_SHAPES + EDIT_GN_SHAPES
                                 + SERVE_GN_SHAPES + TRAIN_GN_SHAPES
                                 + QUALITY_GN_SHAPES}
        | fp32_gn | {(*c, fp32, fp32, 32) for c in QUALITY_GN_SHAPES
                     + GN_SHAPES}
        | {(shape, eps, silu, dt, dt, g) for shape, eps, silu, g
           in MESH_GN_SHAPES for dt in both}
        | {(shape, eps, silu, bf16, bf16, g) for shape, eps, silu, g
           in MESH_SPLIT_GN_SHAPES}
        | {(*c, bf16, bf16, 32) for c in MESH_SERVE_GN_SHAPES},
        "flash_attention_backward": {(*s, dt) for s in BWD_ATTN_SHAPES
                                     for dt in both} | fp32_attn,
        "groupnorm_silu_backward": {(*c, dt, dt, 32) for c in BWD_GN_SHAPES
                                    for dt in both} | fp32_gn,
        "groupnorm_partials": {(shape, dt, 32) for shape, _ in MESH_SPLIT_GN
                               for dt in both}
        | {(shape, bf16, 32) for shape, _ in MESH_SPLIT_HALF_GN
           + MESH_SPLIT_XL_GN},
        "groupnorm_apply": {(shape, silu, dt, dt, 32, MESH_RANKS)
                            for shape, silu in MESH_SPLIT_GN
                            for dt in both}
        | {(shape, silu, bf16, bf16, 32, MESH_RANKS)
           for shape, silu in MESH_SPLIT_HALF_GN + MESH_SPLIT_XL_GN}}


def unchecked_keys(torch, by_shape: dict) -> list:
    """The (kernel, key) pairs of ``by_shape`` ({kernel: {key: launches}})
    that phase 3 does not check."""
    checked = checked_keys(torch)
    return [(name, k) for name, counts in by_shape.items()
            for k in counts if k not in checked[name]]


def check_pngs(run_dir: Path, n: int, side: int = 512):
    pngs = sorted(run_dir.glob("**/frame*.png"))
    sizes = {png_size(p) for p in pngs}
    print(f"{run_dir.name}: {len(pngs)} frames of {sizes}")
    if len(pngs) != n or sizes != {(side, side)}:
        raise AssertionError(f"expected {n} frames of {side}x{side}, got "
                             f"{len(pngs)} of {sizes}")
    shutil.rmtree(run_dir)


def check_frames(label: str, frames: np.ndarray, shape=(8, 512, 512, 3)):
    print(f"{label}: {frames.shape} {frames.dtype} finite "
          f"{bool(np.isfinite(frames).all())} std {frames.std():.4f}")
    if (frames.shape != shape or not np.isfinite(frames).all()
            or not frames.std() > 0):
        raise AssertionError(f"{label} is not finite frames with spread")


def walk_clip(pipe, name: str, steps: int, batch_size=8, guidance=7.5,
              frames: int = 16, side: int = 512,
              prompts=("a red fox in the snow", "a lighthouse at dusk"),
              **kw):
    """2 prompts x ``frames`` frames (16: two dispatches at batch 8) at
    ``side``², or with ``batch_size=None`` the pipeline's own batch;
    ``kw`` goes to ``walk`` (the add-ons' conditioning)."""
    shutil.rmtree(WORK / name, ignore_errors=True)
    pipe.walk(prompts=list(prompts), seeds=[42, 1337],
              num_interpolation_steps=frames, output_dir=str(WORK),
              name=name, height=side, width=side, num_inference_steps=steps,
              guidance_scale=guidance, batch_size=batch_size,
              make_video=False, **kw)


def dispatch_inputs(torch, pipe, frames: int = 8):
    """(cond, uncond, noise) of one dispatch of ``frames`` frames at 512²."""
    cond = pipe.embed_text("a red fox in the snow").expand(frames, -1, -1)
    noise = torch.randn(frames, 64, 64, 4,
                        generator=torch.Generator().manual_seed(3))
    return cond, pipe.embed_text(""), noise


def read_frames(run_dir: Path, n: int) -> np.ndarray:
    """The first ``n`` frames of a walk's run directory, uint8 (n, H, W,
    3)."""
    from PIL import Image
    return np.stack([np.asarray(Image.open(p).convert("RGB"))
                     for p in sorted(run_dir.glob("**/frame*.png"))[:n]])


def phase_main(torch, models):
    """The walk and a float32 dispatch; -> (launches, the walk's first 8
    frames)."""
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    pipe = StableDiffusionWalkPipeline(models, device=torch.device("cuda"))
    launches, walk_s = counted_run(torch, "main", lambda: walk_clip(
        pipe, "chip_smoke_walk", 50))
    frames = read_frames(WORK / "chip_smoke_walk", 8)
    check_pngs(WORK / "chip_smoke_walk", 16)
    cond, uncond, noise = dispatch_inputs(torch, pipe)
    counted_run(torch, "main float32 dispatch", lambda: check_frames(
        "main: float32 dispatch", pipe.engine.denoise_frames(
            cond, uncond, noise, num_inference_steps=50, guidance_scale=7.5,
            output_dtype="float32")))
    print(f"main: {16 / walk_s:.4f} frames/s (walk wall time, first call "
          f"included) on {gpu_line()}")
    return launches, frames, 16 / walk_s


def warm_seconds(torch, dispatch, runs: int = 3,
                 warmed: bool = False) -> tuple[float, list]:
    """min and all of ``runs`` wall times of ``dispatch()``, which ends in a
    device->host copy, after one call that warms it (none if ``warmed``:
    the caller has just made one)."""
    if not warmed:
        dispatch()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch()
        times.append(time.perf_counter() - t0)
    return min(times), ["%.4f" % t for t in times]


def phase_fewstep(torch, models):
    """dpm-20 x step_cache=2 "ends" walk, a fast-preset dispatch of 8
    frames, a fast-preset walk at its own default batch (16), and the
    full-width DeepCache splice; -> {run: {kernel: launches}}."""
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    dev = torch.device("cuda")
    pipe = StableDiffusionWalkPipeline(models, dev, scheduler="dpm",
                                       step_cache=2,
                                       step_cache_policy="ends")
    out = {}
    out["dpm20_k2_ends"], walk_s = counted_run(
        torch, "fewstep dpm-20 x k=2 ends walk",
        lambda: walk_clip(pipe, "chip_smoke_fewstep", 20))
    check_pngs(WORK / "chip_smoke_fewstep", 16)
    cond, uncond, noise = dispatch_inputs(torch, pipe)

    warm, times = warm_seconds(torch, lambda: pipe.engine.denoise_frames(
        cond, uncond, noise, num_inference_steps=20, guidance_scale=7.5,
        output_dtype="uint8"))
    line = gpu_line()
    print(f"fewstep: dpm-20 x k=2 ends warm dispatch of 8 frames "
          f"{warm:.4f} s (min of {times}), {8 / warm:.4f} frames/s, on "
          f"{line}")
    print(f"fewstep: walk of 16 frames {walk_s:.3f} s, {16 / walk_s:.4f} "
          f"frames/s (first dispatch included) on {line}")

    fast = StableDiffusionWalkPipeline(models, dev, fast=True)
    out["fast"], fast_s = counted_run(
        torch, "fewstep fast dispatch", lambda: check_frames(
            "fewstep: fast dispatch", fast.engine.denoise_frames(
                cond, uncond, noise, num_inference_steps=50,
                guidance_scale=7.5, output_dtype="float32")))
    print(f"fewstep: fast (pndm-50 x k=3 x interval (0.1, 0.85)) dispatch "
          f"of 8 frames {fast_s:.4f} s (first call) on {line}")
    # the walk a user of the preset gets: one dispatch of 16 frames, CFG
    # segment at UNet batch 32
    out["fast_walk"], fast_walk_s = counted_run(
        torch, "fewstep fast walk", lambda: walk_clip(
            fast, "chip_smoke_fast", 50, batch_size=None))
    check_pngs(WORK / "chip_smoke_fast", 16)
    cond16, _, noise16 = dispatch_inputs(torch, fast, frames=16)
    warm, times = warm_seconds(torch, lambda: fast.engine.denoise_frames(
        cond16, uncond, noise16, num_inference_steps=50, guidance_scale=7.5,
        output_dtype="uint8"), runs=2)
    print(f"fewstep: fast walk of 16 frames at its default batch "
          f"{fast_walk_s:.3f} s (first call included); warm dispatch of 16 "
          f"frames {warm:.4f} s (min of {times}), {16 / warm:.4f} frames/s, "
          f"on {line}")

    # the splice at full width: CFG batch 16, split 1
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(16, 4, 64, 64, device=dev, generator=g)
    t = torch.full((16,), 501.0, device=dev)
    ctx = torch.cat([uncond.expand(8, -1, -1), cond])
    with torch.no_grad():
        plain = models.unet(x, t, ctx)
        eps, deep = models.unet(x, t, ctx, cache_split=1)
        shallow, _ = models.unet(x, t, ctx, cache_split=1, deep_feature=deep)
    if tuple(deep.shape) != (16, 640, 64, 64) or deep.dtype != torch.bfloat16:
        raise AssertionError(f"deep feature {tuple(deep.shape)} {deep.dtype}")
    # the shallow pass reruns the full pass's kernels on the same inputs,
    # so both passes must equal the plain call bit for bit
    if not torch.equal(eps, plain) or not torch.equal(shallow, eps):
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in ((eps, plain), (shallow, eps))]
        raise AssertionError(f"splice: split full pass vs plain max_abs_err "
                             f"{errs[0]:.3e}, shallow vs full {errs[1]:.3e}")
    print(f"fewstep: splice at batch 16: full pass with cache_split=1 and "
          f"the shallow pass fed its deep feature {tuple(deep.shape)} both "
          f"equal the plain call bit for bit")
    return out


def check_sampler_on_card(torch, name: str, eta: float, steps: int = 10):
    """The sampler's scale_model_input and step on the card against the
    same calls on the CPU, fp32, on the same inputs: (8, 4, 64, 64) latents
    at the sampler's initial sigma, a model output and (stochastic
    samplers) a noise field a step, all drawn on the host.  -> max abs
    error."""
    from stable_diffusion_videos_tpu_torch.core.schedulers import (
        SchedulerConfig, get_scheduler)
    sched = get_scheduler(name)
    tables = sched.make_tables(SchedulerConfig(), steps,
                               **({"eta": eta} if name == "ddim" else {}))
    g = torch.Generator().manual_seed(7)
    shape = (8, 4, 64, 64)
    x0 = torch.randn(shape, generator=g) * sched.init_noise_sigma(tables)
    n = sched.num_loop_steps(tables)
    outs = [torch.randn(shape, generator=g) for _ in range(n)]
    noises = ([torch.randn(shape, generator=g) for _ in range(n)]
              if sched.draws_noise(tables) else [None] * n)
    runs = {}
    for dev in ("cpu", "cuda"):
        x = x0.to(dev)
        state, trace = sched.init_state(tables, x), []
        for i in range(n):
            inp = sched.scale_model_input(tables, state, i, x)
            noise = None if noises[i] is None else noises[i].to(dev)
            state, x = sched.step(tables, state, i, outs[i].to(dev), x,
                                  noise)
            trace += [inp.cpu(), x.cpu()]
        runs[dev] = trace
    err = 0.0
    for a, b in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(a, b, **SAMPLER_TOL,
                                   msg=lambda m: f"{name} on the card: {m}")
        err = max(err, (a - b).abs().max().item())
    return err


def phase_distilled(torch, models):
    """lcm-4 cond-only frozen walk and dispatches with the KL and the tiny
    decoder, one 10-step CFG dispatch per remaining sampler with its device
    check, and the tiled decode at 1024²; -> {run: {kernel: launches}}."""
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    dev = torch.device("cuda")
    line = gpu_line()
    lcm = dict(scheduler="lcm", guidance_interval=(0.0, 0.0),
               frozen_noise=True)
    run = dict(num_inference_steps=4, guidance_scale=1.0)
    pipe = StableDiffusionWalkPipeline(models, dev, **lcm)
    out = {}
    out["lcm4_walk"], walk_s = counted_run(
        torch, "distilled lcm-4 walk", lambda: walk_clip(
            pipe, "chip_smoke_lcm", 4, guidance=1.0))
    check_pngs(WORK / "chip_smoke_lcm", 16)
    print(f"distilled: lcm-4 walk of 16 frames {walk_s:.3f} s, "
          f"{16 / walk_s:.4f} frames/s (first dispatch included) on {line}")
    cond, uncond, noise = dispatch_inputs(torch, pipe)
    tiny = Engine(models, dev, tiny_decoder=True, **lcm)
    for label, eng in (("KL decoder", pipe.engine), ("TAESD", tiny)):
        key = "lcm4_taesd" if eng is tiny else "lcm4_dispatch"
        out[key], _ = counted_run(
            torch, f"distilled lcm-4 dispatch, {label}", lambda: check_frames(
                f"distilled: lcm-4 dispatch, {label}", eng.denoise_frames(
                    cond, uncond, noise, output_dtype="float32", **run)))
        warm, times = warm_seconds(torch, lambda: eng.denoise_frames(
            cond, uncond, noise, output_dtype="uint8", **run))
        print(f"distilled: lcm-4 cond-only frozen warm dispatch of 8 frames, "
              f"{label}: {warm:.4f} s (min of {times}), {8 / warm:.4f} "
              f"frames/s, on {line}")

    for name, eta in (("ddim", 0.0), ("ddim", 0.5), ("euler", 0.0),
                      ("euler_ancestral", 0.0), ("lms", 0.0),
                      ("unipc", 0.0)):
        label = f"{name}-10" + (f" eta {eta}" if eta else "")
        eng = Engine(models, dev, scheduler=name)
        out[label.replace(" ", "_")], secs = counted_run(
            torch, f"distilled {label} dispatch", lambda: check_frames(
                f"distilled: {label} dispatch", eng.denoise_frames(
                    cond, uncond, noise, num_inference_steps=10,
                    guidance_scale=7.5, eta=eta, output_dtype="float32")))
        err = check_sampler_on_card(torch, name, eta)
        print(f"distilled: {label} CFG dispatch of 8 frames {secs:.4f} s "
              f"(first call); its steps on the card vs the CPU, fp32: "
              f"max_abs_err {err:.3e} ({SAMPLER_TOL})")

    tiled = Engine(models, dev, vae_tile=64, vae_tile_overlap=16)
    lat = torch.randn(8, 128, 128, 4, generator=torch.Generator()
                      .manual_seed(9))
    frames = {}
    out["tiled_decode"], tiled_s = counted_run(
        torch, "distilled tiled decode", lambda: frames.update(
            x=tiled.decode_latents_tiled(lat)))
    check_frames("distilled: decode_latents_tiled of (8, 4, 128, 128)",
                 frames["x"], shape=(8, 1024, 1024, 3))
    warm, times = warm_seconds(torch, lambda: tiled.decode_latents_tiled(
        lat), runs=2)
    print(f"distilled: decode_latents_tiled (8, 4, 128, 128) -> "
          f"{frames['x'].shape}, tile 64 overlap 16 (9 tiles): first "
          f"{tiled_s:.4f} s, warm {warm:.4f} s (min of {times}), frames "
          f"copied to the host, on {line}")
    return out


def family_bundle(torch, family: str, seed: int):
    """A random bf16 bundle of ``family`` at its published widths, drawn on
    the card, with its build time printed."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    t0 = time.perf_counter()
    models = SDModels.random(family, seed=seed, dtype=torch.bfloat16,
                             device=torch.device("cuda"))
    torch.cuda.synchronize()
    n = sum(p.numel() for m in (models.unet, models.vae, models.text_encoder,
                                models.text_encoder_2) if m is not None
            for p in m.parameters())
    print(f"families: random {family} bundle ({n / 1e9:.3f}B parameters) "
          f"built in {time.perf_counter() - t0:.1f} s")
    return models


def phase_families(torch):
    """SDXL-base at 1024² and SD 2.1 768-v at 768² at their published
    widths: walks, warm dispatches and one SDXL ``fast`` dispatch; -> ({run:
    {kernel: launches}}, the SDXL bundle's VAE and bigG tower for phase
    9)."""
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    dev = torch.device("cuda")
    line = gpu_line()
    prompt, out = "a red fox in the snow", {}

    xl = family_bundle(torch, "sdxl", seed=2)
    pipe = StableDiffusionWalkPipeline(xl, dev)  # pndm-50, batch 1
    out["sdxl_walk"], walk_s = counted_run(
        torch, "families SDXL walk", lambda: walk_clip(
            pipe, "chip_smoke_sdxl", 50, batch_size=None, frames=2,
            side=1024))
    check_pngs(WORK / "chip_smoke_sdxl", 2, side=1024)
    print(f"families: SDXL-base walk of 2 frames at 1024² {walk_s:.3f} s "
          f"(first dispatch included) on {line}")
    eng = pipe.engine
    xl_in = dict(cond=eng.embed_text(prompt), uncond=eng.embed_text(""),
                 noise=torch.randn(1, 128, 128, 4, generator=torch.Generator()
                                   .manual_seed(3)),
                 pooled=eng.embed_text_pooled(prompt),
                 uncond_pooled=eng.embed_text_pooled(""),
                 num_inference_steps=50, guidance_scale=7.5)
    # the walk just ran this work at this batch: no warming call
    warm, times = warm_seconds(torch, lambda: eng.denoise_frames(
        output_dtype="uint8", **xl_in), runs=2, warmed=True)
    print(f"families: SDXL-base warm dispatch of 1 frame at 1024², pndm-50 "
          f"CFG 7.5: {warm:.4f} s (min of {times}) on {line}")
    fast = StableDiffusionWalkPipeline(xl, dev, fast=True)
    out["sdxl_fast"], fast_s = counted_run(
        torch, "families SDXL fast dispatch", lambda: check_frames(
            "families: SDXL fast dispatch", fast.engine.denoise_frames(
                output_dtype="float32", **xl_in), shape=(1, 1024, 1024, 3)))
    print(f"families: SDXL-base fast (pndm-50 x step_cache=2) dispatch of 1 "
          f"frame {fast_s:.4f} s (first call) on {line}")
    xl_parts = dict(vae_config=xl.vae_config, vae=xl.vae,
                    text_config=xl.text_config_2,
                    text_encoder=xl.text_encoder_2)
    del pipe, fast, eng, xl, xl_in
    torch.cuda.empty_cache()

    sd2 = family_bundle(torch, "sd2", seed=3)
    pipe = StableDiffusionWalkPipeline(sd2, dev, scheduler="ddim",
                                       batch_bucket=8)
    out["sd2_walk"], walk_s = counted_run(
        torch, "families SD 2.x walk", lambda: walk_clip(
            pipe, "chip_smoke_sd2", 50, batch_size=8, frames=4, side=768))
    check_pngs(WORK / "chip_smoke_sd2", 4, side=768)
    print(f"families: SD 2.1 768-v walk of 4 frames at 768² (one dispatch "
          f"padded to 8) {walk_s:.3f} s (first dispatch included) on {line}")
    cond = pipe.embed_text(prompt).expand(8, -1, -1)
    noise = torch.randn(8, 96, 96, 4, generator=torch.Generator()
                        .manual_seed(3))
    uncond = pipe.embed_text("")
    frames = {}
    out["sd2_dispatch"], first = counted_run(
        torch, "families SD 2.x dispatch", lambda: frames.update(
            x=pipe.engine.denoise_frames(
                cond, uncond, noise, num_inference_steps=50,
                guidance_scale=7.5, output_dtype="float32")))
    check_frames("families: SD 2.x dispatch", frames["x"],
                 shape=(8, 768, 768, 3))
    print(f"families: SD 2.x dispatch of 8 frames {first:.4f} s (first "
          f"call at this batch) on {line}")
    # the counted dispatch just ran this work at this batch
    warm, times = warm_seconds(torch, lambda: pipe.engine.denoise_frames(
        cond, uncond, noise, num_inference_steps=50, guidance_scale=7.5,
        output_dtype="uint8"), runs=2, warmed=True)
    print(f"families: SD 2.1 768-v warm dispatch of 8 frames at 768², "
          f"ddim-50 v-prediction CFG 7.5: {warm:.4f} s (min of {times}), "
          f"{8 / warm:.4f} frames/s, on {line}")
    del pipe, sd2
    torch.cuda.empty_cache()
    return out, xl_parts


def refiner_bundle(torch, xl_parts=None, seed: int = 4):
    """The random bf16 SDXL-refiner bundle at its published widths, drawn
    on the card: its UNet drawn, with phase 8's SDXL VAE and bigG tower
    (the same published geometry) when given, else the whole bundle
    drawn."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.models.tokenizer import \
        HashTokenizer
    from stable_diffusion_videos_tpu_torch.models.unet import (
        UNet2DCondition, UNetConfig)
    from stable_diffusion_videos_tpu_torch.models.weights import (
        load_state_dict, random_state_dict)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    t0 = time.perf_counter()
    if xl_parts is None:
        models = SDModels.random("sdxl_refiner", seed=seed, dtype=bf16,
                                 device=dev)
    else:
        cfg = UNetConfig.sd_xl_refiner()
        with torch.device("meta"):
            unet = UNet2DCondition(cfg)
        load_state_dict(unet, random_state_dict(unet, seed, 0.02, bf16, dev),
                        bf16)
        models = SDModels.refiner(SDModels(
            cfg, xl_parts["vae_config"], xl_parts["text_config"],
            unet.eval().requires_grad_(False), xl_parts["vae"],
            xl_parts["text_encoder"], HashTokenizer(
                vocab_size=xl_parts["text_config"].vocab_size)))
    models = models.to(dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in models.unet.parameters())
    print(f"edit: random SDXL-refiner bundle (UNet {n / 1e9:.3f}B "
          f"parameters{', VAE and bigG reused' if xl_parts else ''}) built "
          f"in {time.perf_counter() - t0:.1f} s")
    return models


def phase_edit(torch, models, frames, xl_parts):
    """Encode whole and tiled, img2img under pndm-50 and ddim-50, inpaint,
    vid2vid, the TAESD encoder, and the SDXL refiner's img2img frame; ->
    {run: {kernel: launches}}."""
    from stable_diffusion_videos_tpu_torch.audio.analysis import save_wav
    from stable_diffusion_videos_tpu_torch.media.video import (FrameWriter,
                                                               probe_video)
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    dev = torch.device("cuda")
    line = gpu_line()
    prompt, out = "a watercolour painting of a fox", {}
    WORK.mkdir(parents=True, exist_ok=True)
    if frames is None:  # phase 5 did not run: one dispatch's frames
        cond, uncond, noise = dispatch_inputs(
            torch, StableDiffusionWalkPipeline(models, dev))
        frames = Engine(models, dev).denoise_frames(
            cond, uncond, noise, num_inference_steps=20,
            output_dtype="uint8")
    src = frames.astype(np.float32) / 255.0 * 2.0 - 1.0    # (8, 512², 3)
    src_1024 = src.repeat(2, axis=1).repeat(2, axis=2)
    pipe = StableDiffusionWalkPipeline(models, dev)

    # the KL encoder, whole at 512² and in 9 tiles of 512² at 1024²
    tiled = Engine(models, dev, vae_tile=64, vae_tile_overlap=16)
    for label, eng, x, side in (("encode", pipe.engine, src, 64),
                                ("tiled_encode", tiled, src_1024, 128)):
        lat = {}
        out[label], first = counted_run(
            torch, f"edit {label}", lambda: lat.update(
                z=eng.encode_image(x).cpu().numpy()))
        check_frames(f"edit: {label}", lat["z"], shape=(8, side, side, 4))
        warm, times = warm_seconds(
            torch, lambda: eng.encode_image(x).cpu(), runs=2, warmed=True)
        print(f"edit: {label} of 8 frames at {side * 8}² -> latents "
              f"{lat['z'].shape}: first {first:.4f} s, warm {warm:.4f} s "
              f"(min of {times}) on {line}")

    # img2img at strength 0.6 beside a txt2img dispatch, on the same frames
    cond, uncond, noise = dispatch_inputs(torch, pipe)
    warm, times = warm_seconds(torch, lambda: pipe.engine.denoise_frames(
        cond, uncond, noise, num_inference_steps=50, guidance_scale=7.5,
        output_dtype="uint8"), runs=2)
    print(f"edit: txt2img pndm-50 warm dispatch of 8 frames {warm:.4f} s "
          f"(min of {times}) on {line}")
    for name in ("pndm", "ddim"):
        p = pipe if name == "pndm" else StableDiffusionWalkPipeline(
            models, dev, scheduler=name)
        res = {}
        run = dict(strength=0.6, num_inference_steps=50, guidance_scale=7.5)
        out[f"img2img_{name}50"], first = counted_run(
            torch, f"edit img2img {name}-50", lambda: res.update(x=p.img2img(
                frames, prompt, output_type="np", **run)))
        check_frames(f"edit: img2img {name}-50", res["x"])
        warm, times = warm_seconds(torch, lambda: p.img2img(
            frames, prompt, output_type="np", **run), runs=2, warmed=True)
        print(f"edit: img2img {name}-50 at strength 0.6 (30 steps) of 8 "
              f"frames, encode included: first {first:.4f} s, warm "
              f"{warm:.4f} s (min of {times}) on {line}")

    # inpaint: the left half regenerated, the right half kept; then
    # nothing masked, which must give the source's round trip
    mask = np.zeros((512, 512), np.float32)
    mask[:, :256] = 1.0
    res = {}
    out["inpaint_pndm50"], first = counted_run(
        torch, "edit inpaint pndm-50", lambda: res.update(x=pipe.inpaint(
            frames, mask, prompt, num_inference_steps=50,
            guidance_scale=7.5, output_type="np")))
    check_frames("edit: inpaint pndm-50", res["x"])
    warm, times = warm_seconds(torch, lambda: pipe.inpaint(
        frames, mask, prompt, num_inference_steps=50, guidance_scale=7.5,
        output_type="np"), runs=2, warmed=True)
    recon = pipe.engine.decode_latents(pipe.engine.encode_image(src))
    keep_all = pipe.inpaint(frames, np.zeros_like(mask), prompt,
                            num_inference_steps=50, guidance_scale=7.5,
                            output_type="np")
    keep_all_max = float(np.abs(keep_all - recon).max())
    # away from the seam by the decoder's 3x3 convolutions' reach (its
    # mid-block attention still sees the whole latent)
    kept = np.abs(res["x"][:, :, 320:] - recon[:, :, 320:]).mean()
    regen = np.abs(res["x"][:, :, :192] - recon[:, :, :192]).mean()
    print(f"edit: inpaint pndm-50 of 8 frames: first {first:.4f} s, warm "
          f"{warm:.4f} s (min of {times}) on {line}; against the source "
          f"encoded and decoded: nothing masked max abs {keep_all_max:.3e} "
          f"(limit {INPAINT_KEPT['keep_all_max']:.3e}); left half masked, "
          f"mean abs kept half {kept:.5f} (limit "
          f"{INPAINT_KEPT['half_mean']}), regenerated half {regen:.5f}")
    if (keep_all_max > INPAINT_KEPT["keep_all_max"]
            or kept > INPAINT_KEPT["half_mean"]):
        raise AssertionError(f"inpaint: the kept region moved (nothing "
                             f"masked {keep_all_max:.3e}, half {kept:.5f})")

    # vid2vid of a 16-frame video written by the port's own writer (its
    # ladder's first available rung: no ffmpeg here, and the native MJPEG
    # sink needs libjpeg's headers, so cv2), read back through
    # probe_video/read_video_frames, restyled and written out with audio
    source = FrameWriter(WORK / "edit_source.mp4", fps=8)
    for fr in np.concatenate([frames, frames[:, :, ::-1]]):
        source.add_frame(np.ascontiguousarray(fr))
    source.close()
    info = probe_video(source.output_filepath)
    print(f"edit: source video by the {source.backend} writer: {info}")
    wav = WORK / "edit_audio.wav"
    save_wav(str(wav), (0.1 * np.sin(np.arange(44100) * 0.0628))
             .astype(np.float32), 22050)
    video = {}
    out["vid2vid"], secs = counted_run(
        torch, "edit vid2vid", lambda: video.update(path=pipe.vid2vid(
            source.output_filepath, prompt, strength=0.5,
            num_inference_steps=50, guidance_scale=7.5, batch_size=8,
            shared_noise=True, audio_filepath=str(wav),
            output_filepath=str(WORK / "edit_vid2vid.mp4"))))
    written = probe_video(video["path"])
    print(f"edit: vid2vid of 16 frames at 512², pndm-50 strength 0.5, shared "
          f"field, batch 8, with audio: {secs:.4f} s, {16 / secs:.4f} "
          f"frames/s (the whole call: read, encode, 2 dispatches, write; "
          f"first call) on {line}; wrote {written}")
    if (written["n_frames"], written["width"], written["height"]) != (
            16, 512, 512):
        raise AssertionError(f"vid2vid wrote {written}")
    for p in WORK.glob("edit_*"):
        p.unlink()

    # the TAESD encoder at its published geometry (cuDNN: no hand-written
    # kernel runs, so it is timed, not counted)
    x01 = torch.from_numpy(frames).to(dev).permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        z = models.taesd.encode(x01)
    check_frames("edit: TAESD encode", z.float().cpu().numpy(),
                 shape=(8, 4, 64, 64))
    with torch.no_grad():
        warm, times = warm_seconds(
            torch, lambda: models.taesd.encode(x01).cpu(), runs=2,
            warmed=True)
    print(f"edit: TAESD encoder of 8 frames at 512²: warm {warm:.4f} s (min "
          f"of {times}) on {line}")
    del pipe, tiled
    torch.cuda.empty_cache()

    # the SDXL refiner: one 1024² img2img frame
    refiner = refiner_bundle(torch, xl_parts)
    rpipe = StableDiffusionWalkPipeline(refiner, dev, scheduler="ddim")
    image = frames[:1].repeat(2, axis=1).repeat(2, axis=2)
    run = dict(strength=0.3, num_inference_steps=50, guidance_scale=7.5,
               output_type="np")
    res = {}
    out["refiner_img2img"], first = counted_run(
        torch, "edit refiner img2img", lambda: res.update(x=rpipe.img2img(
            image, prompt, **run)))
    check_frames("edit: refiner img2img", res["x"], shape=(1, 1024, 1024, 3))
    warm, times = warm_seconds(torch, lambda: rpipe.img2img(
        image, prompt, **run), runs=2, warmed=True)
    print(f"edit: SDXL-refiner img2img of 1 frame at 1024², ddim-50 at "
          f"strength 0.3 (15 steps) CFG 7.5, encode included: first "
          f"{first:.4f} s, warm {warm:.4f} s (min of {times}) on {line}")
    del rpipe, refiner
    torch.cuda.empty_cache()
    return out


def write_safetensors(path: Path, tensors: dict):
    """float32 arrays, or bf16 torch tensors, -> a ``.safetensors`` file
    (8-byte little-endian header length, JSON header, raw little-endian
    data, one tensor after another): the card's machine has no safetensors
    package, and the port reads the format itself."""
    header, blobs, offset = {}, [], 0
    for name, value in tensors.items():
        if str(getattr(value, "dtype", "")) == "torch.bfloat16":
            import torch
            kind = "BF16"  # the raw 16-bit patterns
            blob = value.detach().cpu().contiguous().view(torch.int16) \
                .numpy().tobytes()
        else:
            kind = "F32"
            blob = np.ascontiguousarray(value, "<f4").tobytes()
        header[name] = {"dtype": kind, "shape": list(value.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for blob in blobs:
            f.write(blob)


def edge_map(side: int = 512) -> np.ndarray:
    """A (side, side, 3) canny map in [0, 1] of a drawn scene: a disc, a
    frame and a diagonal band."""
    from stable_diffusion_videos_tpu_torch.pipeline.walk import canny_map
    yy, xx = np.mgrid[:side, :side]
    img = np.zeros((side, side), np.uint8)
    img[(yy - side * 0.4) ** 2 + (xx - side * 0.6) ** 2 < (side * 0.2) ** 2] \
        = 200
    img[side // 8:side // 8 * 7, side // 10:side // 10 + 12] = 255
    img[np.abs(yy - xx) < side // 16] = 120
    return canny_map(np.repeat(img[..., None], 3, axis=2))


def kohya_lora(unet, rank: int = 8, alpha: float = 4.0, seed: int = 8):
    """A kohya LoRA of rank ``rank`` on every attention projection and every
    resnet convolution of ``unet`` -> ({file key: array}, {module name:
    (down, up)}); the 3x3 convolutions get LoCon pairs."""
    rng = np.random.default_rng(seed)
    tensors, pairs = {}, {}
    for name, mod in unet.named_modules():
        if not (name.endswith(("to_q", "to_k", "to_v", "to_out.0"))
                or name.endswith(("resnets.0.conv1", "resnets.0.conv2",
                                  "resnets.1.conv1", "resnets.1.conv2",
                                  "resnets.2.conv1", "resnets.2.conv2"))):
            continue
        w = mod.weight
        spatial = tuple(w.shape[2:])
        down = rng.standard_normal((rank, w.shape[1]) + spatial,
                                   dtype=np.float32) * 0.05
        up = rng.standard_normal((w.shape[0], rank) + (1,) * len(spatial),
                                 dtype=np.float32) * 0.05
        key = "lora_unet_" + name.replace(".", "_")
        tensors.update({f"{key}.lora_down.weight": down,
                        f"{key}.lora_up.weight": up,
                        f"{key}.alpha": np.array(alpha, np.float32)})
        pairs[name] = (down, up)
    return tensors, pairs


def in_turns(torch, dispatches: dict) -> dict:
    """Warm seconds of each ``{label: dispatch}``, timed in turns a, b (one
    call each after one warming call): -> {label: seconds}."""
    return {label: warm_seconds(torch, fn, runs=1)[0]
            for label, fn in dispatches.items()}


def phase_addons(torch, models, frames):
    """ControlNet walks, dispatches and vid2vid, the IP-Adapter's tower,
    walk and dispatches, a weighted prompt's walk and dispatch, and a LoRA
    and textual-inversion merge with one dispatch; -> {run: {kernel:
    launches}}."""
    from stable_diffusion_videos_tpu_torch.models.controlnet import \
        ControlNetBundle
    from stable_diffusion_videos_tpu_torch.models.ip_adapter import (
        IPAdapter, preprocess_clip_image)
    from stable_diffusion_videos_tpu_torch.models.lora_file import apply_lora
    from stable_diffusion_videos_tpu_torch.models.safety import \
        CLIPVisionConfig
    from stable_diffusion_videos_tpu_torch.models.textual_inversion import \
        apply_textual_inversion
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    line = gpu_line()
    out = {}
    WORK.mkdir(parents=True, exist_ok=True)
    plain = Engine(models, dev)
    if frames is None:  # phase 5 did not run: one dispatch's frames
        cond, uncond, noise = dispatch_inputs(
            torch, StableDiffusionWalkPipeline(models, dev))
        frames = plain.denoise_frames(cond, uncond, noise,
                                      num_inference_steps=20,
                                      output_dtype="uint8")
    run = dict(num_inference_steps=LATER_STEPS, guidance_scale=7.5)

    def nets(seed):
        t0 = time.perf_counter()
        cn = ControlNetBundle.random(seed=seed, dtype=bf16, device=dev)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in cn.module.parameters())
        print(f"addons: random ControlNet ({n / 1e9:.3f}B parameters) built "
              f"in {time.perf_counter() - t0:.1f} s")
        return cn

    # ControlNet: a walk on one edge map, warm dispatches beside plain ones
    edge = edge_map()
    cn = nets(5)
    pipe = StableDiffusionWalkPipeline(models, dev, controlnet=cn)
    out["controlnet_walk"], walk_s = counted_run(
        torch, "addons ControlNet walk", lambda: walk_clip(
            pipe, "chip_smoke_cn", LATER_STEPS, control_image=edge))
    check_pngs(WORK / "chip_smoke_cn", 16)
    cond, uncond, noise = dispatch_inputs(torch, pipe)
    timed = in_turns(torch, {
        label: (lambda kw=kw: pipe.engine.denoise_frames(
            cond, uncond, noise, output_dtype="uint8", **run, **kw))
        for label, kw in (("plain", {}), ("ControlNet", dict(control=edge)))})
    print(f"addons: ControlNet walk of 16 frames {walk_s:.3f} s (first "
          f"dispatch included); warm dispatch of 8 frames, "
          f"pndm-{LATER_STEPS} CFG 7.5, "
          f"in turns: ControlNet {timed['ControlNet']:.4f} s, "
          f"plain {timed['plain']:.4f} s, ratio "
          f"{timed['ControlNet'] / timed['plain']:.4f}, on {line}")

    # two ControlNets under guess_mode
    cn2 = nets(7)
    multi = Engine(models, dev, controlnet=[cn, cn2])
    res = {}
    out["multi_guess"], secs = counted_run(
        torch, "addons two ControlNets guess_mode", lambda: res.update(
            x=multi.denoise_frames(cond, uncond, noise, output_dtype="float32",
                                   control=[edge, edge[:, ::-1]],
                                   control_scale=[1.0, 0.5],
                                   guess_mode=True, **run)))
    check_frames("addons: two ControlNets, guess_mode", res["x"])
    print(f"addons: dispatch of 8 frames with two ControlNets under "
          f"guess_mode {secs:.4f} s (first call) on {line}")
    del multi, cn2

    # vid2vid with canny maps from each source frame
    source = np.concatenate([frames, frames[:, :, ::-1]])
    out["vid2vid_canny"], secs = counted_run(
        torch, "addons vid2vid canny", lambda: res.update(x=pipe.vid2vid(
            source, "a watercolour painting of a fox", strength=0.5,
            batch_size=8, control_from_source="canny", output_type="frames",
            **run)))
    sizes = {im.size for im in res["x"]}
    print(f"addons: vid2vid of 16 frames, control_from_source='canny', "
          f"strength 0.5, batch 8: {secs:.4f} s, {16 / secs:.4f} frames/s "
          f"(first call) on {line}; {len(res['x'])} frames of {sizes}")
    if len(res["x"]) != 16 or sizes != {(512, 512)}:
        raise AssertionError(f"vid2vid gave {len(res['x'])} of {sizes}")

    # the taps zeroed: the walk must equal the plain walk frame for frame
    cn.zeroed()
    out["controlnet_zeroed_walk"], _ = counted_run(
        torch, "addons zeroed ControlNet walk", lambda: walk_clip(
            pipe, "chip_smoke_cn_zero", LATER_STEPS, control_image=edge))
    walk_clip(pipe, "chip_smoke_cn_plain", LATER_STEPS)
    zero = read_frames(WORK / "chip_smoke_cn_zero", 16)
    base = read_frames(WORK / "chip_smoke_cn_plain", 16)
    print(f"addons: zeroed ControlNet walk vs plain walk, 16 uint8 frames: "
          f"equal {np.array_equal(zero, base)}")
    if not np.array_equal(zero, base):
        raise AssertionError("the zeroed ControlNet changed the frames (max "
                             f"{np.abs(zero.astype(int) - base).max()})")
    for name in ("chip_smoke_cn_zero", "chip_smoke_cn_plain"):
        shutil.rmtree(WORK / name)
    del pipe, cn
    torch.cuda.empty_cache()

    # IP-Adapter SD 1.5 with its ViT-H/14 image tower
    t0 = time.perf_counter()
    ip = IPAdapter.random(models.unet_config, seed=6,
                          vision=CLIPVisionConfig.vit_h14(), device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in ip.image_encoder.parameters())
    print(f"addons: random IP-Adapter (tower {n / 1e9:.3f}B parameters, "
          f"fp32) built in {time.perf_counter() - t0:.1f} s")
    image = frames[3]
    with torch.no_grad():
        pix = preprocess_clip_image(torch.from_numpy(image[None] / 255.0),
                                    224)
        emb = ip.image_encoder(pix.float().to(dev)).cpu()
        tok = ip.image_tokens(image)
        ip.to(torch.device("cpu"))  # the same weights on the CPU
        emb_cpu = ip.image_encoder(pix.float())
        tok_cpu = ip.image_tokens(image)
        ip.to(dev)
    for label, got, want in (("embedding", emb, emb_cpu),
                             ("tokens", tok.cpu(), tok_cpu)):
        torch.testing.assert_close(got, want, **TOWER_TOL,
                                   msg=lambda m: f"IP {label}: {m}")
        print(f"addons: IP image {label} {tuple(got.shape)} on the card vs "
              f"the CPU, fp32: max_abs_err "
              f"{(got - want).abs().max().item():.3e} ({TOWER_TOL})")
    ipipe = StableDiffusionWalkPipeline(models, dev, ip_adapter=ip)
    out["ip_walk"], walk_s = counted_run(
        torch, "addons IP-Adapter walk", lambda: walk_clip(
            ipipe, "chip_smoke_ip", LATER_STEPS, ip_image=image))
    check_pngs(WORK / "chip_smoke_ip", 16)
    timed = in_turns(torch, {
        label: (lambda eng=eng, kw=kw: eng.denoise_frames(
            cond, uncond, noise, output_dtype="uint8", **run, **kw))
        for label, eng, kw in (("plain", plain, {}),
                               ("IP-Adapter", ipipe.engine,
                                dict(ip_tokens=tok)))})
    print(f"addons: IP-Adapter walk of 16 frames {walk_s:.3f} s (first "
          f"dispatch included); warm dispatch of 8 frames, in "
          f"turns: IP-Adapter {timed['IP-Adapter']:.4f} s, plain "
          f"{timed['plain']:.4f} s, ratio "
          f"{timed['IP-Adapter'] / timed['plain']:.4f}, on {line}")
    out["ip_scale0"], _ = counted_run(
        torch, "addons IP-Adapter ip_scale=0", lambda: res.update(
            x=ipipe.engine.denoise_frames(cond, uncond, noise,
                                          output_dtype="uint8", ip_tokens=tok,
                                          ip_scale=0.0, **run)))
    base = plain.denoise_frames(cond, uncond, noise, output_dtype="uint8",
                                **run)
    print(f"addons: ip_scale=0 dispatch vs plain, 8 uint8 frames: equal "
          f"{np.array_equal(res['x'], base)}")
    if not np.array_equal(res["x"], base):
        raise AssertionError("ip_scale=0 changed the frames")
    del ipipe, ip
    torch.cuda.empty_cache()

    # a weighted prompt of two 77-token windows
    long_prompt = ("a (red fox:1.3) in the [blurry] snow, " + ", ".join(
        f"detail{i}" for i in range(90)))
    wpipe = StableDiffusionWalkPipeline(models, dev, prompt_weighting=True)
    out["weighted_walk"], walk_s = counted_run(
        torch, "addons weighted walk", lambda: walk_clip(
            wpipe, "chip_smoke_weighted", LATER_STEPS,
            prompts=(long_prompt, "a (lighthouse:1.2) at dusk")))
    check_pngs(WORK / "chip_smoke_weighted", 16)
    wcond = wpipe.engine.embed_text_weighted(long_prompt, 2).expand(8, -1, -1)
    wuncond = wpipe.engine.embed_text_weighted("", 2)
    print(f"addons: weighted context {tuple(wcond.shape)}")
    timed = in_turns(torch, {
        label: (lambda args=args: plain.denoise_frames(
            *args, noise, output_dtype="uint8", **run))
        for label, args in (("plain", (cond, uncond)),
                            ("weighted", (wcond, wuncond)))})
    print(f"addons: weighted walk of 16 frames {walk_s:.3f} s (first "
          f"dispatch included); warm dispatch of 8 frames, in "
          f"turns: two windows (Sk=154) {timed['weighted']:.4f} s, plain "
          f"(Sk=77) {timed['plain']:.4f} s, ratio "
          f"{timed['weighted'] / timed['plain']:.4f}, on {line}")
    del wpipe

    # a kohya LoRA and a textual-inversion file, merged, then a dispatch
    tensors, pairs = kohya_lora(models.unet)
    lora_path, ti_path = WORK / "addons_lora.safetensors", \
        WORK / "addons_ti.safetensors"
    write_safetensors(lora_path, tensors)
    vectors = np.random.default_rng(9).standard_normal(
        (2, models.text_config.hidden_size), dtype=np.float32) * 0.02
    write_safetensors(ti_path, {"emb_params": vectors})
    before = {name: models.unet.get_submodule(name).weight.clone()
              for name in pairs}
    t0 = time.perf_counter()
    merged = apply_textual_inversion(apply_lora(models, lora_path), ti_path)
    torch.cuda.synchronize()
    print(f"addons: LoRA ({len(pairs)} modules, rank 8) and textual "
          f"inversion merged in {time.perf_counter() - t0:.2f} s")
    worst = 0.0
    for name, (down, up) in pairs.items():
        w0 = before[name].float()
        if not torch.equal(models.unet.get_submodule(name).weight, before[name]):
            raise AssertionError(f"the merge changed the base bundle's {name}")
        u2, d2 = up.reshape(up.shape[0], -1), down.reshape(down.shape[0], -1)
        d = torch.from_numpy((u2 @ d2).reshape(w0.shape) * 0.5).to(dev)
        terms = torch.from_numpy((np.abs(u2) @ np.abs(d2)).reshape(
            w0.shape) * 0.5).to(dev)  # alpha 4 / rank 8
        want = w0 + d
        err = (merged.unet.get_submodule(name).weight.float() - want).abs()
        limit = (LORA_MERGE_RTOL * want.abs()
                 + LORA_MERGE_FP32 * (w0.abs() + terms))
        ratio = (err / limit.clamp_min(1e-30)).max().item()
        worst = max(worst, ratio)
        if ratio > 1.0:
            raise AssertionError(f"LoRA merge of {name}: W_after - W_before "
                                 f"is off its delta by {ratio:.3f} of the "
                                 "limit")
    table = merged.text_encoder.text_model.embeddings.token_embedding.weight
    rows = table[-2:].float().cpu().numpy()
    ti_err = float(np.abs(rows - vectors).max())
    print(f"addons: LoRA merge: W_after - W_before vs the delta, worst "
          f"error {worst:.4f} of the limit ({LORA_MERGE_RTOL:.3e} of |W + "
          f"delta| + {LORA_MERGE_FP32} of |W| + |up|·|down|); TI "
          f"rows {tuple(table.shape)} vs the file's vectors max_abs_err "
          f"{ti_err:.3e} (bf16)")
    if ti_err > np.abs(vectors).max() * 2.0 ** -8 or \
            merged.text_config.eos_token_id != models.tokenizer.eos_token_id:
        raise AssertionError("textual inversion rows or EOS id are wrong")
    lora_eng = Engine(merged, dev)
    tcond = lora_eng.embed_text("a red fox, addons_ti style").expand(8, -1, -1)
    out["lora_ti_dispatch"], secs = counted_run(
        torch, "addons LoRA + TI dispatch", lambda: res.update(
            x=lora_eng.denoise_frames(tcond, lora_eng.embed_text(""), noise,
                                      output_dtype="float32", **run)))
    check_frames("addons: LoRA + TI dispatch", res["x"])
    print(f"addons: LoRA + TI dispatch of 8 frames {secs:.4f} s (first call) "
          f"on {line}")
    del lora_eng, merged
    for p in (lora_path, ti_path):
        p.unlink()
    torch.cuda.empty_cache()
    return out


def synthetic_frames(n: int = 8, side: int = 512) -> np.ndarray:
    """``n`` distinct uint8 frames (gradients, checkerboards, noise,
    stripes, rings, colour blocks): decoded random-weight frames are nearly
    flat and embed alike, these do not."""
    y, x = np.mgrid[0:side, 0:side] / (side - 1)
    rng = np.random.default_rng(21)

    def board(k):
        return (np.indices((side, side)) // k).sum(0) % 2

    r = np.hypot(x - 0.5, y - 0.5)
    blocks = np.kron(rng.random((4, 4, 3)), np.ones((side // 4, side // 4, 1)))
    out = [np.stack([x, y, 1 - x], -1), np.repeat(board(32)[..., None], 3, -1),
           rng.random((side, side, 3)),
           np.stack([np.sin(20 * x) ** 2, np.cos(13 * y) ** 2, x * y], -1),
           np.stack([r, 1 - r, (10 * r) % 1], -1), blocks,
           np.stack([board(8), 1 - board(64), 0.5 + 0 * x], -1),
           np.stack([y, 0.2 + 0 * x, x * (1 - y)], -1)]
    return (np.clip(np.stack(out[:n]), 0, 1) * 255).round().astype(np.uint8)


def random_rrdbnet(torch, config, seed: int) -> dict:
    """An RRDBNet's basicsr-named weights drawn N(0, 0.02) from a numpy
    seed, conv_last's bias moved up 0.5 so the output sits inside [0, 1]
    (0.5 ± 0.03 at x4plus's geometry) instead of at the clip."""
    from stable_diffusion_videos_tpu_torch.models.rrdbnet import RRDBNet
    from stable_diffusion_videos_tpu_torch.models.weights import \
        random_state_dict
    with torch.device("meta"):
        shapes = RRDBNet(config)
    sd = {k: torch.from_numpy(v) for k, v in
          random_state_dict(shapes, seed, 0.02).items()}
    sd["conv_last.bias"] += 0.5
    return sd


class DeviceSpans:
    """Wraps a method of one object so that each call is bracketed by CUDA
    events: the device time of the work it enqueues, read after a
    synchronize, with no wait in the call."""

    def __init__(self, torch, obj, name: str):
        self.torch, self.pairs = torch, []
        inner = getattr(obj, name)

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kw)
            end.record()
            self.pairs.append((start, end))
            return out
        setattr(obj, name, timed)

    def seconds(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


def phase_post(torch, models, frames):
    """The upsampler, the safety checker, ToMe and FreeU checked against
    the CPU and timed, then the composite walk and its resume; -> {run:
    {kernel: launches}}."""
    import cv2

    from stable_diffusion_videos_tpu_torch.models.rrdbnet import \
        RRDBNetConfig
    from stable_diffusion_videos_tpu_torch.models.safety import (
        SAFETY_HEAD, SafetyChecker, SafetyConfig, preprocess_for_safety)
    from stable_diffusion_videos_tpu_torch.models.unet import \
        fourier_lowpass_scale
    from stable_diffusion_videos_tpu_torch.ops.tome import (build_plan, merge,
                                                            unmerge)
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.pipeline.upsampling import \
        RealESRGANModel
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    dev, f32, bf16 = torch.device("cuda"), torch.float32, torch.bfloat16
    line = gpu_line()
    out = {}
    WORK.mkdir(parents=True, exist_ok=True)
    synth = synthetic_frames()
    if frames is None:
        frames = synth

    # the upsampler: RealESRGAN_x4plus's geometry, written and read back
    t0 = time.perf_counter()
    x4 = RRDBNetConfig.x4plus()
    sd = random_rrdbnet(torch, x4, seed=11)
    pth = WORK / "post_realesrgan_x4plus.pth"
    torch.save({"params_ema": sd}, pth)
    up_cpu = RealESRGANModel.from_pretrained(str(pth), torch.device("cpu"))
    up_dev = RealESRGANModel.from_pretrained(str(pth), dev)
    n = sum(p.numel() for p in up_dev.net.parameters())
    print(f"post: random RealESRGAN x4plus ({n / 1e6:.3f}M parameters) "
          f"written and loaded in {time.perf_counter() - t0:.1f} s")
    nets = [("x4plus params_ema", up_cpu, up_dev)]
    for wrapper, seed in (("params_ema", 12), ("params", 13)):
        path = WORK / f"post_realesrgan_x2plus_{wrapper}.pth"
        torch.save({wrapper: random_rrdbnet(torch, RRDBNetConfig(scale=2),
                                            seed)}, path)
        a, b = (RealESRGANModel.from_pretrained(str(path), d)
                for d in (torch.device("cpu"), dev))
        if (a.config.scale, a.net.conv_first.in_channels) != (2, 12):
            raise AssertionError(f"x2plus loaded as {a.config}")
        nets.append((f"x2plus {wrapper}", a, b))
        path.unlink()
    crop = torch.from_numpy(frames[:1, :32, :32].astype(np.float32) / 255.0)
    for label, a, b in nets:
        want, got = a(crop), b(crop.to(dev)).cpu()
        torch.testing.assert_close(got, want, **POST_TOL,
                                   msg=lambda m: f"upsampler {label}: {m}")
        print(f"post: upsampler {label} fp32 on a 32² crop -> "
              f"{tuple(got.shape)}, card vs CPU max_abs_err "
              f"{(got - want).abs().max().item():.3e} ({POST_TOL}); output "
              f"{want.mean().item():.4f} ± {want.std().item():.4f}")
    del nets, up_cpu, up_dev
    x8 = torch.from_numpy(frames[:8]).to(dev).float() / 255.0
    bound_s = 2 * ESRGAN_MACS / np.array([PEAK_OPS[4], PEAK_OPS[2]])
    first = {}  # each dtype's first frame, on the host
    for (dn, dtype), bound in zip((("fp32", f32), ("bf16", bf16)), bound_s):
        up = RealESRGANModel(x4, sd, dev, dtype=dtype)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = up(x8)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            first[dn] = y[0].cpu()
            del y
        least = min(times[1:])
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"post: upsampler {dn}, 8 frames 512² -> 2048²: first "
              f"{times[0]:.4f} s, least of 2 warm {least:.4f} s, "
              f"{least / 8:.4f} s a frame against a bound of "
              f"{bound:.4f} s a frame ({2 * ESRGAN_MACS / 1e12:.2f} TFLOP at "
              f"{'67' if dtype == f32 else '989'} TFLOP/s), share of bound "
              f"{bound * 8 / least:.3f}; peak memory {peak:.2f} GB; on {line}")
        del up
    del x8
    torch.cuda.empty_cache()
    diff = (first["bf16"] - first["fp32"]).abs()
    if not torch.isfinite(first["bf16"]).all():
        raise AssertionError("bf16 upsampler output is not finite")
    print(f"post: upsampler bf16 vs fp32 on frame 0 at 2048² (random "
          f"weights): max_abs {diff.max().item():.4f}, mean_abs "
          f"{diff.mean().item():.5f}, share of pixels off by more than 1/255 "
          f"{(diff > 1 / 255).float().mean().item():.4f}")
    del first, diff

    # the safety checker at CompVis's geometry: tower and head in fp32
    t0 = time.perf_counter()
    scfg = SafetyConfig.sd_v1()
    card = SafetyChecker.random(scfg, seed=7, std=0.02, device=dev)
    ssd = {k: v.cpu() for k, v in card.state_dict().items()}
    n = sum(p.numel() for p in card.parameters())
    print(f"post: random safety checker ({n / 1e9:.3f}B parameters) built "
          f"in {time.perf_counter() - t0:.1f} s")
    pix = preprocess_for_safety(torch.from_numpy(synth[:2] / 255.0).float(),
                                224)
    checker = SafetyChecker.build(scfg, ssd, f32)  # the same, on the CPU
    with torch.no_grad():
        want = (checker.embed(pix), checker(pix))
        got = (card.embed(pix.to(dev)).cpu(), card(pix.to(dev)).cpu())
    torch.testing.assert_close(got[0], want[0], **POST_TOL,
                               msg=lambda m: f"safety embedding: {m}")
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"safety flags {got[1]} vs CPU {want[1]}")
    print(f"post: safety checker fp32, 2 frames: projected embedding card vs "
          f"CPU max_abs_err {(got[0] - want[0]).abs().max().item():.3e} "
          f"({POST_TOL}); flags equal {got[1].tolist()}")
    del card, checker
    # the bundle's checker (bf16 tower, fp32 head) with concept 0 planted on
    # one synthetic frame, its threshold midway to the nearest other frame,
    # the cosines from the same weights in fp32 on the CPU
    k = 5
    sd16 = {name: v if name in SAFETY_HEAD else v.to(bf16)
            for name, v in ssd.items()}
    ref = SafetyChecker.build(scfg, {n_: v.float() for n_, v in sd16.items()})
    with torch.no_grad():
        emb = ref.embed(preprocess_for_safety(
            torch.from_numpy(synth / 255.0).float(), 224))
    cos = emb @ emb[k]
    near = torch.cat([cos[:k], cos[k + 1:]]).max().item()
    sd16["concept_embeds"][0] = emb[k]
    sd16["concept_embeds_weights"][:] = 2.0   # above any cosine
    sd16["concept_embeds_weights"][0] = (cos[k].item() + near) / 2
    sd16["special_care_embeds_weights"][:] = 2.0
    print(f"post: concept 0 planted on synthetic frame {k}: CPU cosines "
          f"{[round(c, 4) for c in cos.tolist()]}, threshold "
          f"{(cos[k].item() + near) / 2:.4f} (half-gap "
          f"{(cos[k].item() - near) / 2:.4f})")
    smodels = models.with_safety_checker(SafetyChecker.build(scfg, sd16, bf16))
    spipe = StableDiffusionWalkPipeline(smodels, dev)
    expected = [j == k for j in range(len(synth))]
    src = torch.from_numpy(synth).to(dev)
    flags = spipe.engine.check_safety(src.float() / 255.0).cpu().tolist()
    blacked, pflags = spipe._postprocess_frames(src, False)
    kept = [np.array_equal(blacked[j], synth[j]) for j in range(len(synth))]
    print(f"post: bf16 checker on the card flags {flags}; _postprocess "
          f"blacks out {[not c for c in kept]}")
    if flags != expected or pflags.tolist() != expected or \
            blacked[k].any() or not all(kept[:k] + kept[k + 1:]):
        raise AssertionError("the planted concept was not flagged alone")
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spipe.engine.check_safety(src.float() / 255.0).cpu()
        times.append(time.perf_counter() - t0)
    bound = 2 * SAFETY_MACS * 8 / PEAK_OPS[2]
    print(f"post: check_safety of 8 frames at 512² (bf16 tower): least of 3 "
          f"warm {min(times[1:]):.4f} s (first {times[0]:.4f} s) against a "
          f"bound of {bound * 1e3:.3f} ms ({2 * SAFETY_MACS / 1e12:.3f} TFLOP "
          f"a frame at 989 TFLOP/s), on {line}")
    del spipe, src, ref

    # ToMe's plan, merge and unmerge at level 0 (16, 4096, 320) in fp32.
    # Plan features whose arithmetic is exact in any order (each token one
    # channel at a random scale: every dot product is one rounded
    # product), so the card's plan must equal the CPU's index for index
    rng = np.random.default_rng(31)
    xe = np.zeros((16, 4096, 320), np.float32)
    np.put_along_axis(xe, rng.integers(0, 320, (16, 4096, 1)),
                      rng.uniform(0.5, 2.0, (16, 4096, 1)).astype(np.float32),
                      axis=2)
    xe = torch.from_numpy(xe)
    n_merge = int(TOME_RATIO * 4096)
    plan_cpu = build_plan(xe, 64, 64, n_merge)
    plan_dev = build_plan(xe.to(dev), 64, 64, n_merge)
    for field in ("src_idx", "dst_idx", "kept", "merged", "assign"):
        if not torch.equal(getattr(plan_dev, field).cpu(),
                           getattr(plan_cpu, field)):
            raise AssertionError(f"ToMe plan {field} differs from the CPU's")
    xr = torch.randn(16, 4096, 320, generator=torch.Generator().manual_seed(3))
    plan_on = plan_cpu._replace(**{
        f: getattr(plan_cpu, f).to(dev)
        for f in ("src_idx", "dst_idx", "kept", "merged", "assign")})
    m_cpu, m_dev = merge(xr, plan_cpu), merge(xr.to(dev), plan_on)
    u_cpu = unmerge(m_cpu * 2.0, plan_cpu, 4096)
    u_dev = unmerge(m_dev * 2.0, plan_on, 4096).cpu()
    for label, got, want in (("merge", m_dev.cpu(), m_cpu),
                             ("unmerge", u_dev, u_cpu)):
        torch.testing.assert_close(got, want, **OPS_TOL,
                                   msg=lambda m: f"ToMe {label}: {m}")
    hb = torch.randn(16, 4096, 320, device=dev).to(bf16)
    plan_ms = time_ms(torch, lambda: build_plan(hb, 64, 64, n_merge))
    plan_b = build_plan(hb, 64, 64, n_merge)
    mu_ms = time_ms(torch, lambda: unmerge(merge(hb, plan_b), plan_b, 4096))
    print(f"post: ToMe at (16, 4096, 320), {n_merge} merged: the plan on the "
          f"card equals the CPU's index for index; merge and unmerge fp32 "
          f"max_abs_err {(m_dev.cpu() - m_cpu).abs().max().item():.3e}, "
          f"{(u_dev - u_cpu).abs().max().item():.3e} ({OPS_TOL}); bf16 "
          f"features: a plan {plan_ms:.4f} ms, merge + unmerge "
          f"{mu_ms:.4f} ms")
    del xe, xr, m_dev, u_dev, hb, plan_b, plan_dev, plan_on

    # FreeU's filter at the skips of up blocks 0 and 1 (CFG batch 16)
    for shape in ((16, 1280, 8, 8), (16, 1280, 16, 16)):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(4))
        want = fourier_lowpass_scale(x, 1, 0.2)
        got = fourier_lowpass_scale(x.to(dev), 1, 0.2).cpu()
        torch.testing.assert_close(got, want, **OPS_TOL,
                                   msg=lambda m: f"FreeU filter: {m}")
        print(f"post: FreeU filter fp32 at {shape}: card vs CPU max_abs_err "
              f"{(got - want).abs().max().item():.3e} ({OPS_TOL})")

    # dispatches of 8: ToMe 0.5 and FreeU in turns with plain; tome=0 and
    # neutral FreeU factors against plain
    run = dict(num_inference_steps=LATER_STEPS, guidance_scale=7.5,
               output_dtype="uint8")
    cond, uncond, noise = dispatch_inputs(torch, StableDiffusionWalkPipeline(
        models, dev, safety=False))
    engines = {"plain": Engine(models, dev),
               "ToMe 0.5": Engine(models.with_tome(TOME_RATIO), dev),
               "FreeU": Engine(models.with_freeu(True), dev)}
    res = {}
    out["tome_dispatch"], _ = counted_run(
        torch, "post ToMe 0.5 dispatch", lambda: res.update(
            tome=engines["ToMe 0.5"].denoise_frames(cond, uncond, noise,
                                                    **run)))
    timed = in_turns(torch, {
        label: (lambda label=label, eng=eng: res.update({
            label: eng.denoise_frames(cond, uncond, noise, **run)}))
        for label, eng in engines.items()})
    for label in ("ToMe 0.5", "FreeU"):
        print(f"post: warm dispatch of 8 frames, pndm-{LATER_STEPS} CFG "
              f"7.5, in turns: "
              f"{label} {timed[label]:.4f} s, plain "
              f"{timed['plain']:.4f} s, ratio "
              f"{timed[label] / timed['plain']:.4f}, on {line}")
    for label, models_ in (("tome=0", models.with_tome(0.0)),
                           ("freeu=(1, 1, 1, 1)",
                            models.with_freeu((1, 1, 1, 1)))):
        got = Engine(models_, dev).denoise_frames(cond, uncond, noise, **run)
        diff = int(np.abs(got.astype(int) - res["plain"]).max())
        print(f"post: {label} dispatch vs plain, 8 uint8 frames: max "
              f"difference {diff}/255")
        if label == "tome=0" and diff != 0 or diff > 2:
            raise AssertionError(f"{label} moved the frames by {diff}/255")
    del engines, res
    torch.cuda.empty_cache()

    # the composite walk: safety, upsample, ToMe 0.5 and FreeU, 16 frames
    name = "chip_smoke_post"
    shutil.rmtree(WORK / name, ignore_errors=True)
    comp = StableDiffusionWalkPipeline(smodels, dev, tome=TOME_RATIO,
                                       freeu=True)
    comp._ensure_upsampler(str(pth))
    spans = {"upsample": DeviceSpans(torch, comp.upsampler, "_run"),
             "safety": DeviceSpans(torch, comp.engine, "check_safety")}
    flagged = []
    check = comp.engine.check_safety
    comp.engine.check_safety = lambda images: flagged.append(
        check(images)) or flagged[-1]
    result = {}
    walk_kw = dict(prompts=["a red fox in the snow", "a lighthouse at dusk"],
                   seeds=[42, 1337], num_interpolation_steps=16,
                   output_dir=str(WORK), name=name, height=512, width=512,
                   num_inference_steps=LATER_STEPS, guidance_scale=7.5,
                   batch_size=8,
                   upsample=True, upsample_weights=str(pth))
    out["composite_walk"], walk_s = counted_run(
        torch, "post composite walk", lambda: result.update(
            video=comp.walk(**walk_kw)))
    run_dir = WORK / name
    first = read_frames(run_dir, 16)
    n_flags = int(sum(f.sum().item() for f in flagged))
    cap = cv2.VideoCapture(result["video"])
    video = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
             int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    print(f"post: composite walk (safety, upsample fp32, ToMe 0.5, FreeU) "
          f"of 16 frames: {walk_s:.3f} s wall (first dispatch included), "
          f"{16 / walk_s:.4f} frames/s; device time a frame: upsampling "
          f"{spans['upsample'].seconds() / 16:.4f} s, safety "
          f"{spans['safety'].seconds() / 16:.4f} s; {n_flags} frame(s) "
          f"flagged; video {Path(result['video']).name} {video[0]} frames of "
          f"{video[1]}x{video[2]}; on {line}")
    if video != (16, 2048, 2048) or first.shape != (16, 2048, 2048, 3):
        raise AssertionError(f"composite walk: video {video}, frames "
                             f"{first.shape}")
    clip = run_dir / f"{name}_000000"
    for p in sorted(clip.glob("frame*.png"))[8:]:
        p.unlink()
    for p in clip.glob(f"{name}_000000.*"):
        p.unlink()  # a clip with its video is complete: resume skips it
    fresh = StableDiffusionWalkPipeline(smodels, dev, tome=TOME_RATIO,
                                        freeu=True)
    out["composite_resume"], resume_s = counted_run(
        torch, "post composite resume", lambda: fresh.walk(
            output_dir=str(WORK), name=name, resume=True))
    again = read_frames(run_dir, 16)
    print(f"post: resume after deleting the last 8 PNGs: {resume_s:.3f} s; "
          f"upsampler from prompt_config.json "
          f"{Path(fresh._upsampler_source() or '-').name}; rebuilt frames "
          f"{again.shape[1:3]} vs the first run's max difference "
          f"{int(np.abs(again.astype(int) - first).max())}/255")
    if again.shape != first.shape or \
            fresh._upsampler_source() != str(pth):
        raise AssertionError("the resume did not rebuild the upsampled "
                             "frames from the recorded weights")
    shutil.rmtree(run_dir)
    pth.unlink()
    del comp, fresh, smodels
    torch.cuda.empty_cache()
    return out


def clip_vocab() -> dict:
    """A vocabulary of CLIP's first 512 entries (the 256 byte symbols, then
    each with ``</w>``) and its two specials at their ids: every prompt
    tokenizes, one symbol a byte, with no merges."""
    from stable_diffusion_videos_tpu_torch.models.tokenizer import \
        _bytes_to_unicode
    chars = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    vocab.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    return vocab


def write_checkpoint(models, root: Path) -> Path:
    """The bundle as a diffusers-layout directory: each model's tensors as
    safetensors and its ``config.json`` at runwayml/stable-diffusion-v1-5's
    keys, the values read from the port's configs; the PNDM scheduler's
    config; a synthetic vocabulary."""
    shutil.rmtree(root, ignore_errors=True)
    u, v, t = models.unet_config, models.vae_config, models.text_config
    levels = len(u.block_out_channels)
    parts = {
        "unet": (models.unet, "diffusion_pytorch_model", {
            "_class_name": "UNet2DConditionModel", "act_fn": "silu",
            "attention_head_dim": u.attention_head_dim,
            "block_out_channels": list(u.block_out_channels),
            "center_input_sample": False,
            "cross_attention_dim": u.cross_attention_dim,
            "down_block_types": ["CrossAttnDownBlock2D" if a
                                 else "DownBlock2D" for a in u.attn_levels],
            "downsample_padding": 1, "flip_sin_to_cos": u.flip_sin_to_cos,
            "freq_shift": u.freq_shift, "in_channels": u.in_channels,
            "layers_per_block": u.layers_per_block,
            "mid_block_scale_factor": 1, "norm_eps": 1e-05,
            "norm_num_groups": 32, "out_channels": u.out_channels,
            "sample_size": u.sample_size,
            "up_block_types": ["CrossAttnUpBlock2D" if a else "UpBlock2D"
                               for a in reversed(u.attn_levels)]}),
        "vae": (models.vae, "diffusion_pytorch_model", {
            "_class_name": "AutoencoderKL", "act_fn": "silu",
            "block_out_channels": list(v.block_out_channels),
            "down_block_types": ["DownEncoderBlock2D"] * levels,
            "in_channels": v.in_channels,
            "latent_channels": v.latent_channels,
            "layers_per_block": v.layers_per_block, "norm_num_groups": 32,
            "out_channels": v.out_channels,
            "sample_size": u.sample_size * v.scale_factor,
            "scaling_factor": v.scaling_factor,
            "up_block_types": ["UpDecoderBlock2D"] * levels}),
        "text_encoder": (models.text_encoder, "model", {
            "architectures": ["CLIPTextModel"],
            "hidden_act": t.hidden_act, "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "layer_norm_eps": t.layer_norm_eps,
            "max_position_embeddings": t.max_position_embeddings,
            "model_type": "clip_text_model",
            "num_attention_heads": t.num_heads,
            "num_hidden_layers": t.num_layers, "projection_dim": 768,
            "vocab_size": t.vocab_size}),
    }
    for sub, (module, stem, config) in parts.items():
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text(json.dumps(config))
        write_safetensors(root / sub / f"{stem}.safetensors",
                          module.state_dict())
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps({
        "_class_name": "PNDMScheduler", "beta_end": 0.012,
        "beta_schedule": "scaled_linear", "beta_start": 0.00085,
        "clip_sample": False, "num_train_timesteps": 1000,
        "set_alpha_to_one": False, "skip_prk_steps": True,
        "steps_offset": 1, "trained_betas": None}))
    (root / "tokenizer").mkdir()
    (root / "tokenizer" / "vocab.json").write_text(json.dumps(clip_vocab()))
    (root / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    return root


def http(port: int, method: str, path: str, body=None, timeout=600):
    """One JSON request to the server on this host -> (status, reply)."""
    from http.client import HTTPConnection
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def served(port: int, path: str, body: dict) -> list:
    """POST ``body`` and demand a 200; -> the reply's images, uint8."""
    import base64
    import io

    from PIL import Image
    status, reply = http(port, "POST", path, body)
    if status != 200:
        raise AssertionError(f"{path} {body.get('prompt')!r}: {status} "
                             f"{reply}")
    return [np.asarray(Image.open(io.BytesIO(base64.b64decode(b))))
            for b in reply["images"]]


def png_b64(frame: np.ndarray) -> str:
    import base64
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def job_until(port: int, job_id: str, done=("done", "error", "cancelled"),
              seconds: float = 300.0, pred=None) -> tuple[dict, list]:
    """Poll /jobs/<id> until its status is in ``done`` (or ``pred(job)``);
    -> (the job, the frames_done values seen)."""
    seen, deadline = [], time.monotonic() + seconds
    while time.monotonic() < deadline:
        _, job = http(port, "GET", f"/jobs/{job_id}")
        seen.append(job.get("progress", {}).get("frames_done", 0))
        if job["status"] in done or (pred is not None and pred(job)):
            return job, seen
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} still {job['status']} after "
                         f"{seconds} s")


class BatchLog:
    """The batcher's and engine's log lines: merged dispatch sizes, and
    out-of-memory splits."""

    def __init__(self):
        import logging
        self.sizes, self.splits = [], []
        log = self

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith("dynamic batch:"):
                    log.sizes.append(int(msg.split()[2]))
                elif msg.startswith("out of device memory"):
                    log.splits.append(msg)

        self.handler = Handler()
        logger = logging.getLogger("sdv_torch")
        logger.setLevel(logging.INFO)
        logger.addHandler(self.handler)

    def take(self) -> tuple[list, list]:
        out = (self.sizes, self.splits)
        self.sizes, self.splits = [], []
        return out


def serve_in_process(torch, models, frames, main_fps, root: Path):
    """Phase serve's in-process part on the diffusers directory ``root``:
    loaded back bit for bit, the HTTP server with dynamic batching over real
    sockets, a forced out-of-memory split; -> ({run: {kernel: launches}},
    the image of ``SERVE_REQUEST`` served alone)."""
    import threading

    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.server import Server
    dev, line, out = torch.device("cuda"), gpu_line(), {}
    req = dict(SERVE_REQUEST)
    prompt, seed = req["prompt"], req["seed"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = StableDiffusionWalkPipeline.from_pretrained(
        root, device="cuda", dtype=models.dtype, safety=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    print(f"serve: from_pretrained of the SD 1.5-layout directory "
          f"({sum(f.stat().st_size for f in root.rglob('*')) / 1e9:.2f} GB "
          f"bf16) {load_s:.2f} s on {line}")
    for part in ("unet", "vae", "text_encoder"):
        want = getattr(models, part).state_dict()
        got = getattr(pipe.models, part).state_dict()
        if sorted(got) != sorted(want) or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"serve: the loaded {part} differs")
    ref = StableDiffusionWalkPipeline(models, dev, safety=False)
    cond, uncond, noise = dispatch_inputs(torch, ref)
    run = dict(num_inference_steps=LATER_STEPS, guidance_scale=7.5,
               output_dtype="uint8")
    a = ref.engine.denoise_frames(cond, uncond, noise, **run)
    b = pipe.engine.denoise_frames(cond, uncond, noise, **run)
    if not np.array_equal(a, b):
        raise AssertionError("serve: the loaded pipeline's frames differ")
    print(f"serve: parameters and an 8-frame pndm-{LATER_STEPS} dispatch's "
          f"frames bit-equal to the bundle's")
    del ref

    log = BatchLog()
    server_root = WORK / "serve_root"
    shutil.rmtree(server_root, ignore_errors=True)
    server = Server(pipe, output_root=str(server_root))
    _, port = server.start(port=0)
    try:
        def health():
            status, h = http(port, "GET", "/health")
            if status != 200 or h["backend"] != "cuda":
                raise AssertionError(f"/health: {status} {h}")
            return h

        warm = {}

        def warm_up():
            status, warm["reply"] = http(port, "POST", "/warmup", {
                "batches": [1, 16], "num_inference_steps": LATER_STEPS})
            warm["status"] = status

        out["warmup"], warm_s = counted_run(torch, "serve warmup", warm_up)
        if warm["status"] != 200:
            raise AssertionError(f"/warmup: {warm}")
        print(f"serve: /health {health()}; /warmup {{batches: [1, 16]}} "
              f"{warm_s:.2f} s ({warm['reply']}) on {line}")

        single = {}

        def one_request():
            single["image"] = served(port, "/generate", req)[0]
        out["generate"], _ = counted_run(torch, "serve generate",
                                         one_request)
        alone = single["image"]
        lat, times = warm_seconds(torch, one_request, runs=3, warmed=True)
        direct = np.asarray(pipe.generate(
            prompt, seed=seed, num_inference_steps=LATER_STEPS)[0])
        if not np.array_equal(alone, direct):
            raise AssertionError("serve: /generate differs from generate()")
        print(f"serve: one /generate (UNet at CFG batch 2, "
              f"pndm-{LATER_STEPS}) least of "
              f"3 warm {lat:.4f} s ({times}); its PNG equals generate()'s; "
              f"on {line}")

        log.take()
        # the window closes when 16 requests are in: room for all 16
        # clients to connect
        server.batcher.max_delay = 1.0
        results = [None] * 16

        def client(i):
            results[i] = served(port, "/generate", {
                "prompt": prompt, "seed": 100 + i,
                "num_inference_steps": LATER_STEPS})[0]

        def sixteen():
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(16)]
            [t.start() for t in threads]
            [t.join() for t in threads]
        out["sixteen clients"], wall = counted_run(
            torch, "serve 16 concurrent /generate", sixteen)
        server.batcher.max_delay = 0.025
        sizes, _ = log.take()
        if any(r is None for r in results) or sum(sizes) != 16:
            raise AssertionError(f"serve: 16 clients, dispatches {sizes}")
        seq = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served(port, "/generate", {"prompt": prompt, "seed": 200 + i,
                                       "num_inference_steps": LATER_STEPS})
            seq.append(time.perf_counter() - t0)
        print(f"serve: 16 concurrent /generate from 16 threads {wall:.4f} s, "
              f"{16 / wall:.4f} images/s, in {len(sizes)} dispatch(es) of "
              f"{sizes}; 4 sequential single requests mean "
              f"{np.mean(seq):.4f} s ({['%.4f' % t for t in seq]}), "
              f"{1 / np.mean(seq):.4f} images/s; on {line}")

        walk = {"prompts": ["a red fox in the snow", "a lighthouse at dusk"],
                "seeds": [42, 1337], "num_interpolation_steps": 8,
                "batch_size": 8, "name": "served", "output_dir": "walks",
                "num_inference_steps": LATER_STEPS}
        job = {}

        def served_walk():
            status, reply = http(port, "POST", "/walk", walk)
            if status != 202:
                raise AssertionError(f"/walk: {status} {reply}")
            job["job"], job["seen"] = job_until(port, reply["job_id"])
        out["walk"], walk_s = counted_run(torch, "serve walk", served_walk)
        done, seen = job["job"], job["seen"]
        video = Path(done.get("result", {}).get("video", ""))
        if (done["status"] != "done" or seen[-1] != 8
                or done["progress"]["frames_total"] != 8
                or server_root.resolve() not in video.resolve().parents
                or not video.is_file()):
            raise AssertionError(f"serve: /walk job {done}")
        main = ("not run" if main_fps is None
                else f"{main_fps:.4f} frames/s")
        print(f"serve: /walk job 2 prompts x 8 frames, batch 8: "
              f"{walk_s:.4f} s, {8 / walk_s:.4f} frames/s (phase 5's walk "
              f"{main}); progress seen "
              f"{sorted(set(seen))}; {video.name} under the output root; "
              f"perf {done['result']['perf']['stages_s']}; on {line}")

        long_walk = {**walk, "num_interpolation_steps": 40,
                     "name": "cancelled"}
        status, reply = http(port, "POST", "/walk", long_walk)
        job_id = reply["job_id"]
        job_until(port, job_id, pred=lambda j: j.get("progress", {}).get(
            "frames_done", 0) >= 8)
        during = served(port, "/generate", req)[0]
        if not np.array_equal(during, alone):
            raise AssertionError("serve: /generate during a /walk differs "
                                 "from the same request served alone")
        t0 = time.perf_counter()
        status, _ = http(port, "DELETE", f"/jobs/{job_id}")
        cancelled, seen = job_until(port, job_id)
        cancel_s = time.perf_counter() - t0
        run_dir = server_root / "walks" / "cancelled"
        left = [p.name for p in run_dir.rglob("*")
                if p.suffix in (".mp4", ".avi")]
        if status != 202 or cancelled["status"] != "cancelled" or left:
            raise AssertionError(f"serve: cancel {status} {cancelled} "
                                 f"{left}")
        # the job stops at its next frame batch: within one dispatch (the
        # 8-frame job's time) and its drain
        if cancel_s > 1.5 * walk_s:
            raise AssertionError(f"serve: cancelled after {cancel_s:.2f} s")
        print(f"serve: /generate during a /walk equals it served alone; "
              f"DELETE to 'cancelled' {cancel_s:.4f} s at "
              f"{cancelled['progress']['frames_done']}/40 frames, no "
              f"container left; on {line}")

        src = (frames[0] if frames is not None
               else synthetic_frames(1)[0])
        mask = np.zeros(src.shape[:2], np.uint8)
        mask[:, :src.shape[1] // 2] = 255
        edit = {}

        def edits():
            edit["img2img"] = served(port, "/img2img", {
                "image": png_b64(src), "prompt": prompt, "seed": 3,
                "num_inference_steps": LATER_STEPS})[0]
            edit["inpaint"] = served(port, "/inpaint", {
                "image": png_b64(src), "mask": png_b64(mask),
                "prompt": prompt, "seed": 3,
                "num_inference_steps": LATER_STEPS})[0]
        out["img2img+inpaint"], edit_s = counted_run(
            torch, "serve img2img and inpaint", edits)
        from PIL import Image
        want = np.asarray(pipe.img2img(Image.fromarray(src), prompt,
                                       seed=3,
                                       num_inference_steps=LATER_STEPS)[0])
        if not np.array_equal(edit["img2img"], want) or any(
                e.shape != src.shape for e in edit.values()):
            raise AssertionError("serve: /img2img differs from img2img()")
        print(f"serve: /img2img (strength 0.75) and /inpaint (left half) of "
              f"a 512² PNG {edit_s:.4f} s; /img2img equals img2img(); on "
              f"{line}")

        race = {}

        def dpm_warmup():
            race["warmup"] = http(port, "POST", "/warmup", {
                "schedulers": ["dpm"], "num_inference_steps": LATER_STEPS})

        def warmup_race():
            t = threading.Thread(target=dpm_warmup)
            t.start()
            time.sleep(0.2)
            race["image"] = served(port, "/generate", req)[0]
            t.join()
        out["warmup dpm + generate"], _ = counted_run(
            torch, "serve /warmup dpm beside /generate", warmup_race)
        if race["warmup"][0] != 200 or not np.array_equal(race["image"],
                                                          alone):
            raise AssertionError(f"serve: /generate beside /warmup dpm is "
                                 f"not the pndm image ({race['warmup']})")
        if pipe.engine.scheduler_name != "pndm":
            raise AssertionError("serve: /warmup switched the sampler")
        print(f"serve: /generate beside /warmup {{schedulers: [dpm]}} "
              f"({race['warmup'][1]}) is the pndm image")

        # out of memory: a cap under which a batch-16 dispatch fails and its
        # halves of 8 run.  cuDNN shrinks its workspace under a cap, so the
        # peaks of uncapped runs do not give it: it is searched between
        # them with short dispatches (2 steps: the decode at 512² is the
        # peak), each read from the engine's split log
        sixteen_req = {"prompts": [prompt] * 16, "seed": 300,
                       "num_inference_steps": LATER_STEPS}
        uncapped = served(port, "/generate", sixteen_req)
        eng = pipe.engine
        peaks = {}
        for b in (8, 16):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eng.warmup(num_inference_steps=2, batches=(b,))
            peaks[b] = torch.cuda.max_memory_reserved()
        total = torch.cuda.get_device_properties(0).total_memory

        from stable_diffusion_videos_tpu_torch.runtime.engine import \
            is_out_of_memory

        def probe(cap):
            """-> the batch sizes that ran out of memory in a batch-16
            dispatch under ``cap`` bytes."""
            torch.cuda.empty_cache()
            log.take()
            torch.cuda.set_per_process_memory_fraction(cap / total)
            try:
                eng.warmup(num_inference_steps=2, batches=(16,))
            except RuntimeError as e:
                if not is_out_of_memory(e):
                    raise
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0)
                torch.cuda.empty_cache()
            return [int(m.split()[6]) for m in log.take()[1]]

        lo, hi, cap, probes = peaks[8] * 0.5, peaks[16], None, []
        for _ in range(10):
            mid = (lo + hi) / 2
            failed = probe(mid)
            probes.append((round(mid / 1e9, 3), failed))
            if failed == [16]:
                cap = mid
                break
            if failed:
                lo = mid  # the halves did not fit either
            else:
                hi = mid  # batch 16 fitted
        print(f"serve: peaks of reserved memory batch 8 {peaks[8] / 1e9:.3f} "
              f"GB, batch 16 {peaks[16] / 1e9:.3f} GB; cap search (GB, the "
              f"batches that ran out) {probes}")
        if cap is None:
            raise AssertionError("serve: no cap splits batch 16 alone")
        torch.cuda.empty_cache()
        log.take()
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            out["oom split"], split_s = counted_run(
                torch, "serve /generate of 16 under the cap",
                lambda: peaks.update(capped=served(port, "/generate",
                                                   sixteen_req)))
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            torch.cuda.empty_cache()
        sizes, splits = log.take()
        diff = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                   for a, b in zip(peaks["capped"], uncapped))
        if sizes != [16] or not splits or diff > 2:
            raise AssertionError(f"serve: capped dispatch {sizes} {splits} "
                                 f"max diff {diff}")
        print(f"serve: under a cap of {cap / 1e9:.3f} GB the 16-request "
              f"/generate split "
              f"({'; '.join(splits)}) in {split_s:.4f} s; images within "
              f"{diff}/255 of the uncapped run; on {line}")
    finally:
        server.shutdown()
    return out, alone


SERVE_REQUEST = {"prompt": "a lighthouse on a cliff at dusk", "seed": 11,
                 "num_inference_steps": LATER_STEPS}


def phase_serve(torch, models, frames, main_fps):
    """The serving path on phase 5's bundle: a diffusers directory written,
    then the command line's ``serve`` on it as a process, started first so
    that it loads while ``serve_in_process`` runs, its image equal to the
    in-process server's; -> {run: {kernel: launches}}."""
    import os
    root = write_checkpoint(models, WORK / "serve_checkpoint")
    port2 = free_port()
    proc_log = WORK / "serve_process.log"
    proc_root = WORK / "serve_process_root"
    shutil.rmtree(proc_root, ignore_errors=True)
    t0 = time.perf_counter()
    with open(proc_log, "w") as f:
        proc = start_background(
            [sys.executable, "-m", "stable_diffusion_videos_tpu_torch",
             "serve", "--checkpoint", str(root), "--port", str(port2),
             "--output-root", str(proc_root)], cwd=ROOT, stdout=f,
            stderr=subprocess.STDOUT, env=dict(os.environ))
    def answered():
        """/health polled every 0.5 s from the process's start: -> its
        status, body and the seconds to its first answer."""
        while True:
            try:
                return (*http(port2, "GET", "/health", timeout=5),
                        time.perf_counter() - t0)
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"serve process exited "
                                         f"{proc.returncode}: "
                                         f"{proc_log.read_text()[-4000:]}")
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("serve process did not answer")
                time.sleep(0.5)
    health = in_background(answered)
    try:
        out, alone = serve_in_process(torch, models, frames, main_fps, root)
        status, h, up_s = health()
        image = served(port2, "/generate", dict(SERVE_REQUEST))[0]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if status != 200 or not np.array_equal(image, alone):
        raise AssertionError(f"serve process: /health {status} {h}; its "
                             "image differs from the in-process server's")
    print(f"serve: `python3 -m stable_diffusion_videos_tpu_torch serve "
          f"--checkpoint DIR`, started with the phase, answered /health "
          f"{up_s:.2f} s after its start (beside the in-process server's "
          f"work) and served the in-process server's image; stopped (rc "
          f"{proc.returncode})")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(proc_root, ignore_errors=True)
    return out


def grads_of(trainer, *batch) -> list:
    """The fp32 masters' gradients of one ``compute_gradients`` call,
    taken off the masters (which are left without gradients)."""
    trainer.compute_gradients(*batch)
    grads = [p.grad for p in trainer.weights.parameters()]
    for p in trainer.weights.parameters():
        p.grad = None
    return grads


def phase_train(torch, models, summary=None):
    """Training on phase 5's bundle through both kernels' backward kernels
    (``summary``: phase 3's, for the backward kernels' ms a step); ->
    {run: {kernel: launches}}."""
    import copy
    import dataclasses
    import io

    from stable_diffusion_videos_tpu_torch.models.lora_file import apply_lora
    from stable_diffusion_videos_tpu_torch.ops import build
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    from stable_diffusion_videos_tpu_torch.training import (
        LCMDistiller, LoRATrainer, TrainConfig, UNetTrainer, VAETrainer,
        make_structured_dataset)
    from stable_diffusion_videos_tpu_torch.training.trainer import \
        draw_t_and_noise
    dev, line, out = torch.device("cuda"), gpu_line(), {}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    # the remat and resume checks compare runs bit for bit: cuDNN's
    # deterministic algorithms (the two backward kernels use no atomics)
    cudnn.deterministic, cudnn.benchmark = True, False
    images, prompts = make_structured_dataset(512)
    engine, held = Engine(models, dev), {}

    def encode():
        with torch.no_grad():
            held.update(lat=engine.encode_image(images[:2]),
                        ctx=engine.embed_text(prompts[:2]).float(),
                        uncond=engine.embed_text([""]).float())
    out["encode"], _ = counted_run(
        torch, "train: the encoder's latents of two structured images",
        encode)
    lat, ctx, uncond = held["lat"], held["ctx"], held["uncond"]

    # 1. the UNet trainer: 3 steps with EMA, seconds and peak memory
    cfg = TrainConfig(learning_rate=1e-4, ema_decay=0.999)
    trainer = UNetTrainer(models, config=cfg, device=dev)
    start = [p.detach().clone() for p in trainer.weights.parameters()[:4]]
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []

    def steps():
        for _ in range(3):
            t0 = time.perf_counter()
            losses.append(trainer.step(lat, ctx))
            secs.append(time.perf_counter() - t0)
    out["unet_3_steps"], _ = counted_run(
        torch, "train: UNet, 3 steps at batch 2", steps, backward=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(a, b) for a, b in zip(
        start, trainer.weights.parameters()[:4]))
    print(f"train: UNet losses {[f'{x:.5f}' for x in losses]}, step seconds "
          f"{[f'{x:.4f}' for x in secs]}: {min(secs[1:]):.4f} s a warm step "
          f"(batch 2, 64² latents, bf16 working copy, fp32 masters, EMA), "
          f"peak {peak:.2f} GiB on {line}")
    if not (np.isfinite(losses).all() and moved == len(start)):
        raise AssertionError(f"train: losses {losses}, {moved} of "
                             f"{len(start)} probed masters moved")
    # the backward kernels' ms a step: the 3 steps' launches by shape times
    # phase 3's ms at that shape (when phase 3 ran)
    if summary is not None:
        from stable_diffusion_videos_tpu_torch.ops.flash_attention import \
            flash_attention_backward
        from stable_diffusion_videos_tpu_torch.ops.groupnorm import \
            groupnorm_silu_backward
        per_step = {
            name: sum(n * summary[name]["rows"][(key[:cut], key[cut])]
                      for key, n in fn.by_shape.items()) / 3
            for name, fn, cut in (
                ("flash_attention_bwd", flash_attention_backward, 5),
                ("groupnorm_silu_bwd", groupnorm_silu_backward, 3))}
        print(f"train: a UNet step's backward kernels (phase 3's row ms × "
              f"launches): attention backward "
              f"{per_step['flash_attention_bwd']:.4f} ms, GroupNorm backward "
              f"{per_step['groupnorm_silu_bwd']:.4f} ms")
    # warm steps with the attention backward's bf16 calls on the tensor
    # cores and on the FMA path, in turns (3 steps a turn), least of each
    lib, read = build.library(), {1: [], 0: []}
    try:
        for on in (1, 0, 0, 1):
            lib.sdv_attention_backward_tensor_cores(on)
            for _ in range(3):
                t0 = time.perf_counter()
                trainer.step(lat, ctx)
                read[on].append(time.perf_counter() - t0)
    finally:
        lib.sdv_attention_backward_tensor_cores(1)
    print(f"train: warm UNet steps in turns (tensor cores, FMA, FMA, tensor "
          f"cores): attention backward on the tensor cores "
          f"{min(read[1]):.4f} s, on the FMA path {min(read[0]):.4f} s "
          f"(all {[f'{x:.4f}' for x in read[1]]} / "
          f"{[f'{x:.4f}' for x in read[0]]})")
    batch = (lat, ctx, *draw_t_and_noise(
        torch.Generator(dev).manual_seed(5), lat, 1000))
    t0 = time.perf_counter()
    plain = grads_of(trainer, *batch)
    plain_s = time.perf_counter() - t0
    trainer.config = dataclasses.replace(cfg, remat=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    remat = grads_of(trainer, *batch)
    remat_s = time.perf_counter() - t0
    remat_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer.config = cfg
    same = all(torch.equal(a, b) for a, b in zip(plain, remat))
    print(f"train: remat gradients bit-equal to plain: {same} (gradients "
          f"{plain_s:.4f} s plain, {remat_s:.4f} s with remat, peak "
          f"{remat_peak:.2f} GiB with remat)")
    del plain, remat
    if not same:
        raise AssertionError("train: remat changed the gradients")
    buf = io.BytesIO()
    t0 = time.perf_counter()
    trainer.save_checkpoint(buf)
    save_s = time.perf_counter() - t0
    trainer.step(lat, ctx)
    after = [p.detach().clone() for p in trainer.weights.parameters()]
    after_ema = [e.clone() for e in trainer.ema_params]
    buf.seek(0)
    trainer.restore_checkpoint(buf)
    trainer.step(lat, ctx)
    resumed = (all(torch.equal(a, p) for a, p in zip(
        after, trainer.weights.parameters())) and all(
        torch.equal(a, e) for a, e in zip(after_ema, trainer.ema_params)))
    print(f"train: checkpoint of {buf.tell() / 2 ** 30:.2f} GiB saved in "
          f"{save_s:.2f} s; the step after its restore bit-equal to the "
          f"step without it: {resumed}")
    del trainer, after, after_ema, buf
    torch.cuda.empty_cache()
    if not resumed:
        raise AssertionError("train: the restored run diverged")

    # 2. one fp32 step at 32² latents, batch 1: the card against the CPU
    rng = np.random.default_rng(17)
    width = models.unet_config.cross_attention_dim
    small = (rng.standard_normal((1, 32, 32, 4), dtype=np.float32) * 0.5,
             rng.standard_normal((1, 77, width), dtype=np.float32) * 0.3,
             np.array([500]),
             rng.standard_normal((1, 32, 32, 4), dtype=np.float32))
    unet32 = copy.deepcopy(models.unet).float()
    card = UNetTrainer(dataclasses.replace(models, unet=unet32), device=dev)
    out["unet_fp32_32"], _ = counted_run(
        torch, "train: UNet fp32 gradient at 32² latents, batch 1",
        lambda: held.update(fp32=grads_of(card, *small)), backward=True)
    g_card = [g.cpu() for g in held.pop("fp32")]
    del card, unet32
    torch.cuda.empty_cache()
    host = UNetTrainer(dataclasses.replace(
        models, unet=copy.deepcopy(models.unet).cpu().float()),
        device=torch.device("cpu"))
    t0 = time.perf_counter()
    g_host = grads_of(host, *small)
    host_s = time.perf_counter() - t0
    names = [n for n, _ in host.weights.master.named_parameters()]
    del host
    dot = sum(float((a.double() * b.double()).sum())
              for a, b in zip(g_card, g_host))
    norms = [sum(float(g.double().square().sum()) for g in gs) ** 0.5
             for gs in (g_card, g_host)]
    cosine = dot / (norms[0] * norms[1])
    top = max(float(g.abs().max()) for g in g_host)
    err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_host))
    def rel_l2(a, b) -> float:
        """A leaf's relative L2 error (a leaf whose CPU gradient is all
        zeros must be all zeros on the card too)."""
        if not bool(b.any()):
            return float("inf") if bool(a.any()) else 0.0
        return float((a.double() - b.double()).norm() / b.double().norm())
    leaf = sorted(((rel_l2(a, b), name)
                   for name, a, b in zip(names, g_card, g_host)),
                  reverse=True)
    print(f"train: fp32 UNet gradient ({sum(g.numel() for g in g_host)} "
          f"values), card against CPU: "
          f"cosine {cosine:.9f}, max error {err / top:.3e} of the largest "
          f"({top:.3e}); worst leaves by relative L2 "
          f"{[(n, f'{r:.3e}') for r, n in leaf[:3]]}, median "
          f"{leaf[len(leaf) // 2][0]:.3e} of {len(leaf)}; bounds "
          f"{TRAIN_GRAD_TOL}; CPU {host_s:.1f} s")
    del g_card, g_host
    if cosine < TRAIN_GRAD_TOL["cosine"] or \
            err / top > TRAIN_GRAD_TOL["max_err"] or \
            leaf[0][0] > TRAIN_GRAD_TOL["leaf_rel_l2"]:
        raise AssertionError("train: the card's gradient is not the CPU's")

    # 3. LoRA rank 8: 3 steps, the base untouched, the .npz merged and run
    base = [v.clone() for v in models.unet.state_dict().values()]
    lora = LoRATrainer(models, rank=8, learning_rate=1e-3, device=dev)
    lora_losses = []
    out["lora_3_steps"], lora_s = counted_run(
        torch, "train: LoRA rank 8, 3 steps at batch 2",
        lambda: lora_losses.extend(lora.step(lat, ctx) for _ in range(3)),
        backward=True)
    kept = all(torch.equal(a, b) for a, b in zip(
        base, models.unet.state_dict().values()))
    path = WORK / "train_lora.npz"
    lora.save_lora(path)
    merged = apply_lora(models, path)
    changed = sum(not torch.equal(a, b) for a, b in zip(
        merged.unet.state_dict().values(), base))
    print(f"train: LoRA losses {[f'{x:.5f}' for x in lora_losses]} in "
          f"{lora_s:.2f} s; base bit-unchanged: {kept}; .npz of "
          f"{path.stat().st_size / 1e6:.2f} MB, {changed} weights changed by "
          f"the merge")
    del lora, base
    if not (kept and changed > 0 and np.isfinite(lora_losses).all()):
        raise AssertionError("train: LoRA run failed its checks")
    pipe = StableDiffusionWalkPipeline(merged, device=dev)
    cond, uncond8, noise = dispatch_inputs(torch, pipe)
    out["lora_dispatch"], _ = counted_run(
        torch, "train: 8-frame dispatch with the trained LoRA merged",
        lambda: check_frames("train: LoRA-merged dispatch",
                             pipe.engine.denoise_frames(
                                 cond, uncond8, noise,
                                 num_inference_steps=50, guidance_scale=7.5,
                                 output_dtype="float32")))
    del pipe, merged
    path.unlink()
    torch.cuda.empty_cache()

    # 4. LCM distillation: 2 steps at batch 2
    distiller = LCMDistiller(models, device=dev)
    lcm_losses = []
    out["lcm_2_steps"], lcm_s = counted_run(
        torch, "train: LCM distillation, 2 steps at batch 2",
        lambda: lcm_losses.extend(distiller.step(lat, ctx, uncond)
                                  for _ in range(2)), backward=True)
    print(f"train: LCM losses {[f'{x:.6f}' for x in lcm_losses]} in "
          f"{lcm_s:.2f} s")
    del distiller
    torch.cuda.empty_cache()
    if not np.isfinite(lcm_losses).all():
        raise AssertionError("train: LCM losses not finite")

    # 5. the VAE: 2 steps at 512², batch 1
    vae = VAETrainer(models, device=dev)
    recs = []

    vae_secs = []

    def vae_run():
        for _ in range(2):
            t0 = time.perf_counter()
            recs.append(vae.step(images[:1]))
            vae_secs.append(time.perf_counter() - t0)
        recs.append(vae.recon_psnr(images[:1]))
    out["vae_2_steps"], vae_s = counted_run(
        torch, "train: VAE, 2 steps at 512², batch 1", vae_run,
        backward=True)
    print(f"train: VAE reconstruction MSE {recs[0]:.5f}, {recs[1]:.5f}, "
          f"PSNR {recs[2]:.3f} dB, in {vae_s:.2f} s; step seconds "
          f"{[f'{x:.4f}' for x in vae_secs]} (the second warm)")
    del vae
    torch.cuda.empty_cache()
    cudnn.deterministic, cudnn.benchmark = saved
    if not np.isfinite(recs).all():
        raise AssertionError("train: VAE run not finite")
    return out


STRUCTURED = ROOT / "tests" / "goldens" / "structured_bundle"
STRUCTURED_LCM = ROOT / "tests" / "goldens" / "structured_lcm_bundle"
# tests/test_torch_structured.py's runs on the trained checkpoint, CFG 3.0,
# and tests/test_torch_distilled.py's lcm-4 cond-only on the student
STRUCTURED_RUNS = {"pndm50": ("pndm", 50, {}),
                   "dpm20_k2_ends": ("dpm", 20, dict(
                       step_cache=2, step_cache_policy="ends")),
                   "fast": ("pndm", 50, dict(fast=True))}
DISTILLED = dict(scheduler="lcm", guidance_interval=(0.0, 0.0),
                 batch_bucket=8)


def dir_gb(root: Path) -> float:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file()) / 1e9


def assert_same_weights(label: str, got, want) -> None:
    """Every parameter of the two bundles' modules bit-equal."""
    from stable_diffusion_videos_tpu_torch.models.io import _state_dicts
    a, b = _state_dicts(got), _state_dicts(want)
    if sorted(a) != sorted(b):
        raise AssertionError(f"{label}: components {sorted(a)} against "
                             f"{sorted(b)}")
    for name, (sd, _) in b.items():
        other = a[name][0]
        if sorted(other) != sorted(sd) or not all(
                other[k].dtype == sd[k].dtype
                and other[k].equal(sd[k].to(other[k].device)) for k in sd):
            raise AssertionError(f"{label}: the {name} differs")


def structured_frames(torch, models, dev, scheduler, steps, kw):
    """The 8 structured prompts (the port's embedding on ``dev``) denoised
    from numpy seed 7's noise at CFG 3.0 -> float32 frames (8, 32, 32, 3)."""
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.training import \
        make_structured_dataset
    _, prompts = make_structured_dataset(32)
    eng = StableDiffusionWalkPipeline(models, dev, scheduler=scheduler,
                                      safety=False, **kw).engine
    h = models.unet_config.sample_size
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (len(prompts), h, h, 4)).astype(np.float32))
    return eng.denoise_frames(eng.embed_text(prompts), eng.embed_text(""),
                              noise, num_inference_steps=steps,
                              guidance_scale=3.0)


def distilled_frames(torch, models, dev, frozen: bool):
    """lcm-4 cond-only on the student, every step's noise field drawn from
    numpy seed 100 + step (one field broadcast over the batch when
    ``frozen``), the same on either device."""
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    from stable_diffusion_videos_tpu_torch.training import \
        make_structured_dataset
    _, prompts = make_structured_dataset(32)
    eng = Engine(models, dev, frozen_noise=frozen, **DISTILLED)
    h = models.unet_config.sample_size
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (len(prompts), h, h, 4)).astype(np.float32))

    def field(i, latents):
        rows = 1 if frozen else latents.shape[0]
        f = np.random.default_rng(100 + i).standard_normal(
            (rows, *latents.shape[1:])).astype(np.float32)
        return torch.from_numpy(f).to(latents.device)
    return eng.denoise_frames(eng.embed_text(prompts), eng.embed_text(""),
                              noise, num_inference_steps=4,
                              guidance_scale=1.0, generator=field)


def check_trained(label: str, card: np.ndarray, cpu: np.ndarray) -> dict:
    from stable_diffusion_videos_tpu_torch.utils.metrics import \
        quality_vs_exact
    q = quality_vs_exact(card, cpu, lpips_device="cpu")
    q["max_abs"] = float(np.abs(card - cpu).max())
    print(f"quality: {label} on the card against the CPU (fp32, TF32 "
          f"off): {q}")
    tol = TRAINED_TOL
    if (card.shape != cpu.shape or q["max_abs"] > tol["max_abs"]
            or q["psnr_min"] < tol["psnr_min"]
            or q["ssim_min"] < tol["ssim_min"] or not cpu.std() > 0.05):
        raise AssertionError(f"quality: {label} is outside {tol}: {q}")
    return q


def random_lpips_npz(path: Path, net: str, seed: int) -> str:
    """LPIPS weights at the published widths drawn from a numpy seed (the
    backbone N(0, 0.05), the heads |N(0, 1)|), written as ``.npz``."""
    from stable_diffusion_videos_tpu_torch.utils.lpips import LPIPS
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in LPIPS(net).state_dict().items():
        w = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        state[k] = np.abs(w) if k.startswith("lin") else w * 0.05
    np.savez(path, **state)
    return str(path)


def phase_quality(torch, models, frames):
    """The native bundle format at full width, the committed trained
    checkpoints read by the port alone and walked on the card against the
    CPU, LPIPS at its published widths, the parity gate and ``validate``;
    -> {run: {kernel: launches}}."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.models.rrdbnet import \
        RRDBNetConfig
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.utils import parity_gate
    from stable_diffusion_videos_tpu_torch.utils.lpips import (
        load_lpips_weights, lpips_distance)
    from stable_diffusion_videos_tpu_torch.utils.metrics import \
        quality_vs_exact
    from stable_diffusion_videos_tpu_torch.utils.validate import \
        run_validation
    dev, cpu, line, out = (torch.device("cuda"), torch.device("cpu"),
                           gpu_line(), {})
    root = WORK / "quality"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    # 1. phase 5's bundle through the native format, and `convert`
    t_part = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models.save(root / "bundle")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = SDModels.load(root / "bundle", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert_same_weights("quality: the loaded SD 1.x bundle", loaded, models)
    ref = StableDiffusionWalkPipeline(models, dev, safety=False)
    pipe = StableDiffusionWalkPipeline(loaded, dev, safety=False)
    cond, uncond, noise = dispatch_inputs(torch, ref)
    # bit-equality holds at any depth: the later phases' steps
    run = dict(num_inference_steps=LATER_STEPS, guidance_scale=7.5,
               output_dtype="uint8")
    got = {}
    for label, p in (("original", ref), ("loaded", pipe)):
        out[f"dispatch_{label}"], _ = counted_run(
            torch, f"quality: {label} bundle's dispatch",
            lambda p=p, label=label: got.__setitem__(
                label, p.engine.denoise_frames(cond, uncond, noise, **run)))
    if not np.array_equal(got["original"], got["loaded"]):
        raise AssertionError("quality: the loaded bundle's frames differ")
    del ref, pipe, loaded
    torch.cuda.empty_cache()
    src = write_checkpoint(models, root / "diffusers")
    # `convert` as a process (on the host alone), beside part 2
    t0 = time.perf_counter()
    convert = start_background(
        [sys.executable, "-m", "stable_diffusion_videos_tpu_torch", "convert",
         "--checkpoint", str(src), "--out", str(root / "converted")],
        cwd=ROOT)
    convert_done = in_background(
        lambda: (convert.wait(timeout=600), time.perf_counter() - t0))

    def pretrained():
        t1 = time.perf_counter()
        return SDModels.from_pretrained(src), time.perf_counter() - t1
    # and the directory read in this process (the host's work), beside it
    pretrained_done = in_background(pretrained)

    # 2. the committed trained checkpoints, fp32, the card against the CPU
    print(f"quality: part 1 {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    trained = {d: SDModels.load(STRUCTURED, device=d) for d in (dev, cpu)}
    quality = {}
    for label, (sched, steps, kw) in STRUCTURED_RUNS.items():
        card = {}
        out[f"trained_{label}"], _ = counted_run(
            torch, f"quality: trained checkpoint {label}",
            lambda: card.setdefault("f", structured_frames(
                torch, trained[dev], dev, sched, steps, kw)))
        quality[label] = check_trained(label, card["f"], structured_frames(
            torch, trained[cpu], cpu, sched, steps, kw))
        if label == "pndm50":
            fp32_card = card["f"]
    student = {d: SDModels.load(STRUCTURED_LCM, device=d) for d in (dev, cpu)}
    for frozen in (False, True):
        label = f"lcm4_{'frozen' if frozen else 'free'}"
        card = {}
        out[f"trained_{label}"], _ = counted_run(
            torch, f"quality: distilled checkpoint {label}",
            lambda: card.setdefault("f", distilled_frames(
                torch, student[dev], dev, frozen)))
        quality[label] = check_trained(label, card["f"], distilled_frames(
            torch, student[cpu], cpu, frozen))
    bf16 = SDModels.load(STRUCTURED, dtype=torch.bfloat16, device=dev)
    card = {}
    out["trained_pndm50_bf16"], _ = counted_run(
        torch, "quality: trained checkpoint pndm50 in bf16",
        lambda: card.setdefault("f", structured_frames(
            torch, bf16, dev, "pndm", 50, {})))
    q = quality_vs_exact(card["f"], fp32_card, lpips_device="cpu")
    print(f"quality: the trained checkpoint's pndm-50 in bf16 against fp32, "
          f"both on the card: {q}")
    if (q["psnr_mean"] < TRAINED_BF16_TOL["psnr_mean"]
            or q["ssim_mean"] < TRAINED_BF16_TOL["ssim_mean"]):
        raise AssertionError(f"quality: bf16 is outside {TRAINED_BF16_TOL}")
    del bf16, student

    # 1, continued: the converted bundle
    print(f"quality: part 2 {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    rc, convert_s = convert_done()
    if rc != 0:
        raise AssertionError(f"quality: convert exited {rc}")
    want, pretrained_s = pretrained_done()
    assert_same_weights("quality: the converted bundle",
                        SDModels.load(root / "converted"), want)
    print(f"quality: SD 1.x bundle (bf16, TAESD) {dir_gb(root / 'bundle'):.3f}"
          f" GB on disk; save {save_s:.2f} s, load onto the card "
          f"{load_s:.2f} s, convert (a process, beside the trained "
          f"checkpoints' runs) {convert_s:.2f} s, from_pretrained of the "
          f"directory (a thread, beside them too) {pretrained_s:.2f} s "
          f"({dir_gb(src):.3f} GB), on {line}; "
          f"every parameter and an 8-frame pndm-{LATER_STEPS} dispatch "
          f"bit-equal, the "
          f"converted bundle bit-equal to from_pretrained")
    del want
    shutil.rmtree(root / "diffusers")
    shutil.rmtree(root / "converted")
    shutil.rmtree(root / "bundle")

    # 3. LPIPS at the published widths: 8 pairs at 512², phase 5's frames
    print(f"quality: part 1, continued {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # against the same frames with seeded noise
    a = frames if frames is not None else synthetic_frames()
    b = np.clip(a.astype(np.int16) + np.random.default_rng(31).integers(
        -12, 13, a.shape), 0, 255).astype(np.uint8)
    for net, seed, cpu_pairs in (("alex", 41, 8), ("vgg", 42, 2)):
        path = random_lpips_npz(root / f"lpips_{net}.npz", net, seed)
        on_card = load_lpips_weights(path, net, device=dev)
        got = lpips_distance(a, b, on_card)
        want = lpips_distance(a[:cpu_pairs], b[:cpu_pairs],
                              load_lpips_weights(path, net, device=cpu))
        err = np.abs(got[:cpu_pairs] - want).max()
        ta, tb = (torch.from_numpy(x).to(dev).float().div(255).mul(2)
                  .sub(1).permute(0, 3, 1, 2) for x in (a, b))
        with torch.no_grad():
            ms = time_ms(torch, lambda: on_card(ta, tb)) / len(a)
        print(f"quality: LPIPS {net} at 512², {len(a)} pairs: {got} on the "
              f"card, max abs err against the CPU ({cpu_pairs} pairs) "
              f"{err:.3e}; {ms:.4f} ms a pair (cuDNN, fp32) on {line}")
        np.testing.assert_allclose(got[:cpu_pairs], want, **LPIPS_TOL)
        del on_card, ta, tb
    torch.cuda.empty_cache()

    # 4. the gate and validate on the card, against the CPU's gate walk
    print(f"quality: part 3 {time.perf_counter() - t_part:.1f} s")
    def gate_walk(models_, device, name):
        StableDiffusionWalkPipeline(models_, device, safety=False).walk(
            prompts=list(parity_gate.GATE_PROMPTS),
            seeds=list(parity_gate.GATE_SEEDS), output_dir=str(root),
            name=name, make_video=False, **parity_gate.GATE_CONFIG)
        return root / name
    reference = gate_walk(trained[cpu], cpu, "reference")
    other = gate_walk(SDModels.load(STRUCTURED_LCM), cpu, "other_model")
    alex = str(root / "lpips_alex.npz")
    pipe = StableDiffusionWalkPipeline(trained[dev], dev, safety=False)
    res = {}
    out["parity_gate"], _ = counted_run(
        torch, "quality: parity gate", lambda: res.setdefault(
            "ok", parity_gate.run_parity_gate(pipe, str(reference),
                                              str(root / "gate"),
                                              lpips_weights=alex)))
    bad = parity_gate.run_parity_gate(pipe, str(other), str(root / "gate2"),
                                      lpips_weights=alex)
    print(f"quality: parity gate against the CPU's frames {res['ok']}; "
          f"against another model's {bad}")
    if not res["ok"]["pass"] or bad["pass"]:
        raise AssertionError("quality: the gate must pass against the CPU's "
                             "frames and fail against another model's")
    esrgan = root / "esrgan.pth"
    torch.save({"params_ema": random_rrdbnet(torch, RRDBNetConfig(), 43)},
               esrgan)
    rep = {}
    out["validate"], validate_s = counted_run(
        torch, "quality: validate", lambda: rep.setdefault(
            "r", run_validation(str(STRUCTURED), str(root / "validate"),
                                reference_frames=str(reference),
                                lpips_weights=alex,
                                upsample_weights=str(esrgan), device=dev)))
    rep = rep["r"]
    print(f"quality: validate in {validate_s:.2f} s: {rep['summary']}, "
          f"pass {rep['pass']}; step curve "
          f"{rep['stages']['step_cache_curve'].get('curve')}")
    if not rep["pass"] or set(rep["summary"].values()) != {"ok"}:
        raise AssertionError(f"quality: validate did not pass every stage: "
                             f"{json.dumps(rep, default=str)[:2000]}")
    shutil.rmtree(root)
    return out


MESH_PROMPTS = ("a red fox in the snow", "a lighthouse at dusk")
# the add-ons over model 2 (PR 16): FreeU at SD 1.x's factors, IP-Adapter
# at ip_scale 1 on 4 tokens of a random 1024-wide embedding
MESH_ADDONS = ("controlnet", "ip_adapter", "tome", "freeu")
MESH_FREEU = (1.5, 1.6, 0.9, 0.2)


def mesh_addon_parts(torch, dtype, dev) -> dict:
    """The add-ons of phase mesh's model-2 checks at SD 1.x's published
    widths, drawn the same on every process: a ControlNet (seed 41, on the
    card), an IP-Adapter (numpy seed 42; its tokens from a random 1024-wide
    embedding, the tower left out) and their dispatch arguments for the
    8 frames of ``dispatch_inputs``."""
    from stable_diffusion_videos_tpu_torch.models.controlnet import \
        ControlNetBundle
    from stable_diffusion_videos_tpu_torch.models.ip_adapter import IPAdapter
    from stable_diffusion_videos_tpu_torch.models.unet import UNetConfig
    ip = IPAdapter.random(UNetConfig.sd_v1(), seed=42).to(dev)
    embeds = np.random.default_rng(43).standard_normal(
        (1, ip.embed_dim)).astype(np.float32)
    return dict(
        controlnet=ControlNetBundle.random(seed=41, dtype=dtype, device=dev),
        control=edge_map(), ip=ip,
        ip_tokens=ip.image_tokens(image_embeds=embeds).cpu())


def mesh_addon_engine(torch, models, parts: dict, addon: str, dev, **kw):
    """An engine with one add-on over ``models`` (left as it is: a tensor-
    parallel engine shards a copy, a spatial one a copy of the UNet, and a
    ControlNet's trunk is sharded on a copy that shares its weights); ->
    (engine, the add-on's dispatch arguments)."""
    import copy
    import dataclasses

    from stable_diffusion_videos_tpu_torch.models.weights import shared_copy
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    mesh = kw.get("mesh")
    if mesh is not None and mesh.shape["model"] > 1 and \
            not kw.get("spatial_shard"):
        models = copy.deepcopy(models)
    else:
        models = dataclasses.replace(models, unet=shared_copy(models.unet))
    extra = {}
    if addon == "controlnet":
        cn = parts["controlnet"]
        kw["controlnet"] = dataclasses.replace(cn, module=shared_copy(
            cn.module))
        extra = dict(control=parts["control"])
    elif addon == "ip_adapter":
        kw["ip_adapter"] = parts["ip"]
        extra = dict(ip_tokens=parts["ip_tokens"], ip_scale=1.0)
    elif addon == "tome":
        models = models.with_tome(TOME_RATIO)
    else:
        models = models.with_freeu(MESH_FREEU)
    return Engine(models, dev, **kw), extra


def mesh_serving(torch, mesh, pipe, counted, log, root: Path) -> dict:
    """Phase mesh's serving over data 2: rank 0 serves ``pipe`` over real
    sockets and is its own client (one request and its PNG against one
    rank's ``generate()``, 16 concurrent requests, a /walk job of 8 frames,
    a cancelled walk and a request after it); rank 1 follows the channel;
    -> this rank's readings."""
    import threading

    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.server import Server
    server = Server(pipe, output_root=str(root / "served"))
    out = {"writer": pipe.writer}
    if mesh.rank != 0:
        counted("serve", server.follow)
        return out
    one = StableDiffusionWalkPipeline(pipe.models, pipe.device, safety=False)
    _, port = server.start(port=0)
    # the window closes when all 16 clients are in
    server.batcher.max_delay = 1.0
    req = dict(SERVE_REQUEST, num_inference_steps=MESH_STEPS)

    def session():
        _, health = http(port, "GET", "/health")
        out["health_mesh"] = health["mesh"]
        served(port, "/generate", req)
        t0 = time.perf_counter()
        got = served(port, "/generate", req)[0]
        out["one_s"] = time.perf_counter() - t0
        want = np.asarray(one.generate(
            req["prompt"], seed=req["seed"],
            num_inference_steps=MESH_STEPS)[0])
        out["png_equal"] = bool(np.array_equal(got, want))
        log.take()
        replies = [None] * 16

        def client(i):
            replies[i] = served(port, "/generate", dict(
                prompt=f"{MESH_PROMPTS[i % 2]}, take {i}", seed=200 + i,
                num_inference_steps=MESH_STEPS))
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        out["merged_s"] = time.perf_counter() - t0
        out["merged_sizes"] = log.take()[0]
        out["merged_ok"] = all(r is not None and len(r) == 1
                               for r in replies)
        walk = dict(prompts=list(MESH_PROMPTS), seeds=[42, 1337],
                    num_interpolation_steps=8, batch_size=8, height=512,
                    width=512, num_inference_steps=MESH_STEPS)
        t0 = time.perf_counter()
        _, job = http(port, "POST", "/walk", dict(walk, name="walk8"))
        job, _ = job_until(port, job["job_id"])
        out["walk_s"] = time.perf_counter() - t0
        out["walk_status"] = job["status"]
        out["walk_pngs"] = len(list((root / "served" / "walk8").glob(
            "**/frame*.png")))
        out["walk_videos"] = len(list((root / "served" / "walk8").glob(
            "walk8.*")))
        _, job = http(port, "POST", "/walk", dict(
            walk, num_interpolation_steps=32, name="cancel"))
        job_until(port, job["job_id"], pred=lambda j: j.get(
            "progress", {}).get("frames_done", 0) >= 8)
        t0 = time.perf_counter()
        http(port, "DELETE", f"/jobs/{job['job_id']}")
        job, _ = job_until(port, job["job_id"])
        out["cancel_s"] = time.perf_counter() - t0
        out["cancel_status"] = job["status"]
        out["cancel_done"] = job.get("progress", {}).get("frames_done")
        out["cancel_left"] = sorted(
            p.name for p in (root / "served" / "cancel").glob("**/*")
            if p.suffix in (".mp4", ".avi"))
        out["after_cancel"] = len(served(port, "/generate", req))

    try:
        counted("serve", session)
    finally:
        server.shutdown()
    return out


def mesh_oom_split(torch, mesh, eng, counted, log, args, run,
                   unsplit=None, name: str = "oom_split",
                   split: bool = False) -> tuple:
    """Phase mesh's out-of-memory split: rank 1 alone capped
    (``torch.cuda.set_per_process_memory_fraction``) so that half the
    frames of ``args`` fit and all of them do not, the cap searched between
    the uncapped peaks with short dispatches as phase serve's; then the
    dispatch of ``args`` under it, split on every rank, against
    ``unsplit``.  Without ``unsplit`` (a model axis) the uncapped dispatch
    runs after the search, and again after the split, on the groups the
    failure had the ranks re-form: the two must be bit-equal.  ``split``:
    the dispatches must launch the split-statistics GroupNorm.  -> (this
    rank's readings, the split frames)."""
    from stable_diffusion_videos_tpu_torch.runtime.engine import \
        is_out_of_memory
    dev, capped, full = mesh.device, mesh.rank == 1, len(args[2])
    total = torch.cuda.get_device_properties(dev).total_memory
    peaks, allocated = {}, {}
    for b in (full // 2, full):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        eng.warmup(num_inference_steps=2, batches=(b,))
        peaks[b] = torch.cuda.max_memory_reserved(dev)
        allocated[b] = torch.cuda.max_memory_allocated(dev)

    def cap_at(fraction):
        if capped:
            torch.cuda.set_per_process_memory_fraction(fraction, dev)

    def probe(cap):
        """-> the batches that ran out of memory on both ranks (the ranks
        agree, so every rank reads the same)."""
        torch.cuda.empty_cache()
        log.take()
        cap_at(cap / total)
        try:
            eng.warmup(num_inference_steps=2, batches=(full,))
        except RuntimeError as e:
            if not is_out_of_memory(e):
                raise
        finally:
            cap_at(1.0)
            torch.cuda.empty_cache()
        return [int(m.split()[6]) for m in log.take()[1]]

    lo, hi, cap, probes = peaks[full // 2] * 0.5, peaks[full], None, []
    for _ in range(10):
        mid = (lo + hi) / 2
        failed = probe(mid)
        probes.append((round(mid / 1e9, 3), failed))
        if failed == [full]:
            cap = mid
            break
        if failed:
            lo = mid
        else:
            hi = mid
    out = dict(peaks=peaks, allocated=allocated, probes=probes, cap=cap)
    if cap is None:
        return out, None
    after = unsplit is None
    if after:
        unsplit = counted(f"{name}_before",
                          lambda: eng.denoise_frames(*args, **run), split)
    reforms = eng.mesh.reforms
    torch.cuda.empty_cache()
    log.take()
    cap_at(cap / total)
    try:
        frames = counted(name, lambda: eng.denoise_frames(*args, **run),
                         split)
    finally:
        cap_at(1.0)
        torch.cuda.empty_cache()
    out["splits"] = log.take()[1]
    out["max_diff"] = int(np.abs(frames.astype(int)
                                 - unsplit.astype(int)).max())
    out["reforms"] = eng.mesh.reforms - reforms
    out["reform_seconds"] = eng.mesh.reform_seconds
    if after:
        out["after_equal"] = bool(np.array_equal(counted(
            f"{name}_after", lambda: eng.denoise_frames(*args, **run),
            split), unsplit))
    return out, frames


def mesh_safety_checker(torch, frames: np.ndarray):
    """A checker at the tiny geometry on the card, fp32, with concept 0
    planted on the first frame's embedding (its threshold midway to the
    nearest other frame's cosine), so that the first frame alone is
    flagged."""
    from stable_diffusion_videos_tpu_torch.models.safety import (
        SafetyChecker, SafetyConfig, preprocess_for_safety)
    checker = SafetyChecker.random(SafetyConfig.tiny(), seed=21, std=0.2)
    checker.to(torch.device("cuda"))
    pix = preprocess_for_safety(torch.from_numpy(frames).cuda(),
                                checker.config.vision.image_size)
    with torch.no_grad():
        emb = checker.embed(pix)
        cos = (emb @ emb.T)[0, 1:].max().item()
        checker.concept_embeds[0] = emb[0]
        checker.concept_embeds_weights[0] = (1.0 + cos) / 2
    return checker


def transport_ms(torch, mesh, dev) -> dict:
    """ms an all-gather over ``mesh``'s model axis of a level-0 activation
    slab, (16, 320, 64, 32) bf16 (21 MB a rank), through the mesh's own
    transport and, under gloo, staged through host memory (the mesh's
    groups without its peer buffers); mean of 10 after one, each rank
    timing the same calls."""
    from stable_diffusion_videos_tpu_torch.parallel.mesh import Mesh
    x = torch.randn(16, 320, 64, 32, device=dev).to(torch.bfloat16)
    ways = {"mesh": mesh}
    if mesh.peers:
        ways["gloo staged"] = Mesh(mesh.shape["data"], mesh.shape["model"],
                                   mesh.rank, mesh.device, mesh.backend,
                                   mesh._groups)
    out = {}
    for name, m in ways.items():
        m.all_gather(x, "model", 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            m.all_gather(x, "model", 1)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 10 * 1e3
    return out


def replicated_state(trainer) -> list:
    """The fp32 tensors a data-parallel trainer replicates: the optimizer's
    parameters (masters or LoRA factors) and Adam's moments, the EMA, the
    LCM target's masters."""
    opt = trainer.optimizer
    params = [p for group in opt.param_groups for p in group["params"]]
    out = [p.detach() for p in params] + [
        opt.state[p][k] for p in params if p in opt.state
        for k in ("exp_avg", "exp_avg_sq")]
    out += getattr(trainer, "ema_params", None) or []
    if hasattr(trainer, "target"):
        out += trainer.target.parameters()
    return out


def replicas_equal(torch, mesh, tensors) -> bool:
    """Whether every data rank holds the same bits in ``tensors`` (one list
    of shapes on every rank): the ranks' buckets all-gathered and compared
    (every bucket, so that the ranks run the same collectives)."""
    from stable_diffusion_videos_tpu_torch.parallel.mesh import flat_buckets
    same = True
    for pieces in flat_buckets(tensors):
        flat = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        every = mesh.all_gather(flat[None], "data", 0)
        same = all(torch.equal(every[0], x) for x in every[1:]) and same
    return same


def mesh_training(torch, mesh, models, counted, root: Path) -> dict:
    """Phase mesh's ``train`` scenario on one rank of a (data 2) mesh: the
    fp32 check against one rank, then the UNet (with its checkpoint's
    resume), LoRA, VAE and LCM trainers in bf16, their replicas compared
    after every step; -> this rank's readings."""
    import copy
    import dataclasses

    from stable_diffusion_videos_tpu_torch.training import (
        LCMDistiller, LoRATrainer, TrainConfig, UNetTrainer, VAETrainer)
    from stable_diffusion_videos_tpu_torch.training.trainer import \
        draw_t_and_noise
    dev, out = mesh.device, {}
    rng = np.random.default_rng(31)
    width = models.unet_config.cross_attention_dim
    reduce_ms = []
    plain_reduce = mesh.all_reduce_mean_

    def timed_reduce(tensors, axis="data"):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        plain_reduce(tensors, axis)
        torch.cuda.synchronize(dev)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    mesh.all_reduce_mean_ = timed_reduce

    def data(b, side):
        return (rng.standard_normal((b, side, side, 4),
                                    dtype=np.float32) * 0.5,
                rng.standard_normal((b, 77, width), dtype=np.float32) * 0.3)

    # 1. fp32 (TF32 off): the averaged gradient before the first update and
    # the masters after 2 steps against one rank's trainer on the same
    # global batch (rank 0 runs that one too)
    lat, ctx = data(4, MESH_TRAIN_SIDES["fp32"])
    m32 = dataclasses.replace(models, unet=copy.deepcopy(models.unet).float())
    cfg = TrainConfig(learning_rate=1e-4, max_grad_norm=MESH_TRAIN_FP32_CLIP)
    tr = UNetTrainer(m32, mesh=mesh, config=cfg)
    batch = (lat, ctx, *draw_t_and_noise(torch.Generator(dev).manual_seed(5),
                                         torch.as_tensor(lat), 1000))
    counted("train_fp32_gradient", lambda: tr.compute_gradients(*batch),
            backward=True)
    grads = [p.grad for p in tr.weights.parameters()]
    tr.optimizer.zero_grad(set_to_none=True)
    ref = None
    if mesh.rank == 0:
        ref = UNetTrainer(m32, config=cfg, device=dev)
        counted("train_fp32_one_rank_gradient",
                lambda: ref.compute_gradients(*batch), backward=True)
        want = [p.grad for p in ref.weights.parameters()]
        ref.optimizer.zero_grad(set_to_none=True)
        dot = sum(float((a.double() * b.double()).sum())
                  for a, b in zip(grads, want))
        norms = [sum(float(g.double().square().sum()) for g in gs) ** 0.5
                 for gs in (grads, want)]
        top = max(float(g.abs().max()) for g in want)
        out["fp32_gradient"] = dict(
            cosine=dot / (norms[0] * norms[1]), norm=norms[1],
            max_err=max(float((a - b).abs().max())
                        for a, b in zip(grads, want)) / top)
    del grads
    counted("train_fp32_2_steps", lambda: [tr.step(lat, ctx)
                                           for _ in range(2)], backward=True)
    if ref is not None:
        for _ in range(2):
            ref.step(lat, ctx)
        out["fp32_masters_max_diff"] = max(
            float((a - b).detach().abs().max()) for a, b in zip(
                tr.weights.parameters(), ref.weights.parameters()))
    out["fp32_replicas_equal"] = replicas_equal(torch, mesh,
                                                replicated_state(tr))
    del tr, ref, m32
    torch.cuda.empty_cache()

    def run(name, make, step, steps, snapshot_after=None):
        """``steps`` counted steps of a fresh trainer, its replicas compared
        after each; -> the trainer and, on rank 0, the host copy of its
        state after ``snapshot_after`` steps (None elsewhere)."""
        torch.cuda.reset_peak_memory_stats(dev)
        trainer, held = make(), {}
        losses, secs, equal, reduces = [], [], [], []

        def steps_():
            for i in range(steps):
                n = len(reduce_ms)
                t0 = time.perf_counter()
                losses.append(step(trainer))
                secs.append(time.perf_counter() - t0)
                reduces.append(sum(reduce_ms[n:]))
                equal.append(replicas_equal(torch, mesh,
                                            replicated_state(trainer)))
                if i == 0 and snapshot_after is not None:
                    trainer.save_checkpoint(root / "train_ckpt.pt")
                if i + 1 == snapshot_after and mesh.rank == 0:
                    held["state"] = [t.to("cpu", copy=True) for t in
                                     replicated_state(trainer)]
        counted(name, steps_, backward=True)
        out[name] = dict(
            losses=losses, seconds=secs, replicas_equal=equal,
            reduce_ms=reduces,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        return trainer, held.get("state")

    # 2. bf16: the UNet at 64² latents, global batch 4 (2 a rank), EMA on;
    # a checkpoint written by rank 0 after step 1, restored on both ranks,
    # whose step 2 must equal the uninterrupted one's: rank 0's state
    # against its host copy of that step, every rank's against rank 0's
    # (one host copy of the 13.8 GB state, not one a rank)
    lat, ctx = data(4, MESH_TRAIN_SIDES["latents"])
    trainer, after2 = run(
        "train_unet", lambda: UNetTrainer(models, mesh=mesh, config=TrainConfig(
            learning_rate=1e-4, ema_decay=0.999)),
        lambda t: t.step(lat, ctx), 3, snapshot_after=2)
    t0 = time.perf_counter()
    trainer.restore_checkpoint(root / "train_ckpt.pt")
    out["train_unet"]["restored_step"] = trainer.step_count
    trainer.step(lat, ctx)
    state = replicated_state(trainer)
    same = replicas_equal(torch, mesh, state)
    if after2 is not None:
        same = all(torch.equal(a.cpu(), b)
                   for a, b in zip(state, after2)) and same
    out["train_unet"]["resumed_equal"] = same
    out["train_unet"]["resume_seconds"] = time.perf_counter() - t0
    out["train_unet"]["host_available"] = host_available_gib()
    del trainer, after2, state
    torch.cuda.empty_cache()
    mesh.barrier()
    if mesh.rank == 0:
        (root / "train_ckpt.pt").unlink()

    # 3. LoRA rank 8 on the same batch; 4. the VAE at 512², global batch 2
    # (1 a rank); 5. LCM distillation at global batch 4
    run("train_lora", lambda: LoRATrainer(models, rank=8, mesh=mesh,
                                          learning_rate=1e-3),
        lambda t: t.step(lat, ctx), 3)
    torch.cuda.empty_cache()
    side = MESH_TRAIN_SIDES["images"]
    images = rng.uniform(-1, 1, (2, side, side, 3)).astype(np.float32)
    run("train_vae", lambda: VAETrainer(models, mesh=mesh),
        lambda t: t.step(images), 2)
    torch.cuda.empty_cache()
    uncond = rng.standard_normal((1, 77, width), dtype=np.float32) * 0.3
    run("train_lcm", lambda: LCMDistiller(models, mesh=mesh),
        lambda t: t.step(lat, ctx, uncond), 2)
    torch.cuda.empty_cache()
    mesh.all_reduce_mean_ = plain_reduce
    return out


def mesh_child(torch, scenario: str, rank: int, world: int, port: int,
               backend: str, devices: list):
    """One rank of phase 15's process group (see ``phase_mesh``); its
    results go to ``WORK/mesh/<scenario>.rank<r>.json`` and ``.npz``."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.models.safety import (
        SafetyChecker, SafetyConfig)
    from stable_diffusion_videos_tpu_torch.parallel import (
        initialize_multihost, make_mesh)
    from stable_diffusion_videos_tpu_torch.parallel.multihost import shutdown
    from stable_diffusion_videos_tpu_torch.parallel.tp import (
        bundle_modules, param_bytes_per_device)
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    root = WORK / "mesh"
    mesh = initialize_multihost(f"localhost:{port}", world, rank,
                                backend=backend, devices=devices,
                                timeout_s=MESH_CHILD_TIMEOUT - 60)
    dev = mesh.device
    inp = dict(np.load(root / "inputs.npz"))
    cond, uncond, noise = (torch.from_numpy(inp[k])
                           for k in ("cond", "uncond", "noise"))
    run = dict(num_inference_steps=MESH_STEPS, guidance_scale=7.5,
               output_dtype="uint8")
    out, arrays, keys = {"rank": rank}, {}, []
    label = f"mesh {scenario} rank {rank}"

    def counted(name, fn, split=False, backward=False):
        got = []
        launches, seconds = counted_run(
            torch, f"{label}: {name}", lambda: got.append(fn()),
            backward=backward, split=split, keys=keys)
        out.setdefault("launches", {})[name] = launches
        out.setdefault("seconds", {})[name] = seconds
        return got[0]

    # data parallel: the walk; its dispatch again on the walk's inputs
    # (warm), each rank's rows against a one-rank engine's (bit-equality is
    # held within one process); the flags.  Set up while the parent runs
    # its one-rank work, the counted runs wait for its go
    models = SDModels.load(root / "bundle", device=dev)
    while not (root / "go").exists():
        time.sleep(0.1)
    pipe = StableDiffusionWalkPipeline(models, dev, mesh=mesh,
                                       safety=False)
    counted("dp_walk", lambda: pipe.walk(
        prompts=list(MESH_PROMPTS), seeds=[42, 1337],
        num_interpolation_steps=16, output_dir=str(root), name="walk",
        height=512, width=512, num_inference_steps=MESH_STEPS,
        guidance_scale=7.5, batch_size=16, make_video=True))
    (embeds, walk_noise, _), = pipe.generate_inputs(
        *MESH_PROMPTS, 42, 1337, pipe._latent_shape(512, 512),
        np.linspace(0.0, 1.0, 16), 16)
    walk_uncond = pipe.embed_text("")
    dp = counted("dp_dispatch", lambda: pipe.engine.denoise_frames(
        embeds, walk_uncond, walk_noise, **run))
    mine = slice(8 * rank, 8 * rank + 8)
    out["dp_rows_equal"] = bool(np.array_equal(
        dp[mine], Engine(models, dev).denoise_frames(
            embeds[mine], walk_uncond, walk_noise[mine], **run)))
    if pipe.writer:
        out["walk_equal"] = bool(np.array_equal(
            read_frames(root / "walk", 16), dp))
        import cv2
        cap = cv2.VideoCapture(str(sorted(
            (root / "walk").glob("walk.*"))[0]))
        out["video_frames"] = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
    checker = SafetyChecker.build(SafetyConfig.tiny(),
                                  torch.load(root / "safety.pt"))
    safe = Engine(models.with_safety_checker(checker), dev, mesh=mesh)
    out["flags"] = safe.check_safety(
        np.load(root / "frames5.npy")).cpu().tolist()
    # serving the data-2 pipeline from rank 0 through the ordered channel
    log = BatchLog()
    out["serve"] = mesh_serving(torch, mesh, pipe, counted, log, root)
    del pipe, safe, models
    # model 2: tensor parallel, then spatial; fp32 (TF32 off) ddim-2
    # final latents and frames, bf16 frames at MESH_STEPS
    model2 = make_mesh(model=2, devices=devices, backend=backend)
    out["transport_ms"] = transport_ms(torch, model2, dev)
    for layout in ("tp", "spatial"):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            models = SDModels.load(root / "bundle", dtype=dtype)
            want = sum(param_bytes_per_device(m, 2)["per_device_bytes"]
                       for m in bundle_modules(models).values())
            # the last layout's engine, and the exchange buffers the
            # ranks have released (CUDA IPC), are gone before the
            # reading
            gc.collect()
            torch.cuda.ipc_collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            eng = Engine(models, dev, mesh=model2, scheduler=(
                "ddim" if dtype == torch.float32 else "pndm"),
                spatial_shard=layout == "spatial",
                debug=dtype == torch.float32)
            torch.cuda.synchronize()
            if layout == "tp":
                out[f"tp_bytes_{dn}"] = [
                    torch.cuda.memory_allocated(dev) - base, want,
                    sum(p.numel() * p.element_size()
                        for m in bundle_modules(eng.models).values()
                        for p in m.parameters())]
            split = layout == "spatial"
            if dtype == torch.float32:
                arrays[f"{layout}_frames32"] = counted(
                    f"{layout}_{dn}", lambda: eng.denoise_frames(
                        cond, uncond, noise, num_inference_steps=2,
                        guidance_scale=7.5), split)
                arrays[f"{layout}_latents"] = \
                    eng.debug_latents[-1].float().cpu().numpy()
            else:
                eng.denoise_frames(cond, uncond, noise,
                                   num_inference_steps=2)  # warm
                arrays[f"{layout}_frames"] = counted(
                    f"{layout}_{dn}", lambda: eng.denoise_frames(
                        cond, uncond, noise, **run), split)
            del eng, models
            torch.cuda.empty_cache()
    # the add-ons over model 2, each layout: fp32 ddim-2 (TF32 off) frames,
    # then a warm bf16 dispatch of 8 frames at MESH_STEPS, timed
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        fp32 = dtype == torch.float32
        base = SDModels.load(root / "bundle", dtype=dtype, device=dev)
        parts = mesh_addon_parts(torch, dtype, dev)
        for layout in ("tp", "spatial"):
            for addon in MESH_ADDONS:
                eng, extra = mesh_addon_engine(
                    torch, base, parts, addon, dev, mesh=model2,
                    scheduler="ddim" if fp32 else "pndm",
                    spatial_shard=layout == "spatial")
                name, split = f"{addon}_{layout}_{dn}", layout == "spatial"
                if fp32:
                    arrays[f"{addon}_{layout}_frames32"] = counted(
                        name, lambda: eng.denoise_frames(
                            cond, uncond, noise, num_inference_steps=2,
                            guidance_scale=7.5, **extra), split)
                else:
                    # warm: one ddim step at the dispatch's shapes
                    eng.denoise_frames(cond, uncond, noise,
                                       num_inference_steps=1,
                                       scheduler="ddim", **extra)
                    arrays[f"{addon}_{layout}_frames"] = counted(
                        name, lambda: eng.denoise_frames(
                            cond, uncond, noise,
                            num_inference_steps=MESH_STEPS,
                            guidance_scale=7.5, output_dtype="uint8",
                            **extra), split)
                del eng, extra
                torch.cuda.empty_cache()
        del base, parts
        torch.cuda.empty_cache()
    # the out-of-memory split on the model axis, under rank 1's cap (after
    # the layouts and add-ons, whose checks hold the ranks bit-equal: the
    # cap leaves rank 1's cuDNN with plans of its own): rank 1 breaks its
    # model group, every rank agrees and re-forms the groups in place, and
    # both split the 8-frame bf16 dispatch.  First the exchange buffers
    # grown to the fp32 decoder's gathers go (a re-form maps new ones at
    # their first capacity), so that the cap's search reads the bf16
    # dispatches' own peaks
    gc.collect()
    model2.reform()
    for layout in ("tp", "spatial"):
        eng = Engine(SDModels.load(root / "bundle", device=dev), dev,
                     mesh=model2, spatial_shard=layout == "spatial")
        out[f"oom_{layout}"], frames = mesh_oom_split(
            torch, model2, eng, counted, log, (cond, uncond, noise), run,
            name=f"oom_{layout}", split=layout == "spatial")
        if frames is not None:
            arrays[f"oom_{layout}_split"] = frames
        del eng, frames
        torch.cuda.empty_cache()
    # the model axis' exchange buffers (grown to the fp32 decoder's
    # gathers) go first: each rank drops its maps of the other's, then
    # frees its own
    del model2
    gc.collect()
    mesh.barrier()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    # then the out-of-memory split every rank agrees on, under rank 1's cap
    # (after the layouts: the cap leaves rank 1's cuDNN with other plans
    # for the decoder than rank 0's, and the layouts hold the ranks' frames
    # bit-equal; before training, whose checks compare reduced values)
    out["oom"], _ = mesh_oom_split(
        torch, mesh, Engine(SDModels.load(root / "bundle", device=dev), dev,
                            mesh=mesh), counted, log,
        (embeds, walk_uncond, walk_noise), run, dp)
    torch.cuda.empty_cache()
    # then training over data 2 (cuDNN's deterministic algorithms, as
    # phase train's bit-equality checks use)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out.update(mesh_training(torch, mesh, SDModels.load(
        root / "bundle", device=dev), counted, root))
    out["keys"] = [(name, repr(k), n) for name, k, n in keys]
    np.savez(root / f"{scenario}.rank{rank}.npz", **arrays)
    (root / f"{scenario}.rank{rank}.json").write_text(json.dumps(out))
    shutdown()


def start_mesh_children(scenario: str, world: int, backend: str,
                        devices: list) -> tuple:
    """Start one ``chip_smoke.py --mesh-child`` process a rank (each sets up
    its process group and loads the bundle, then waits for ``WORK/mesh/go``
    before its counted runs); -> what ``wait_mesh_children`` takes."""
    root = WORK / "mesh"
    port = free_port()
    logs = [root / f"{scenario}.rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(start_background(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-child",
                 scenario, "--rank", str(r), "--world", str(world),
                 "--port", str(port), "--backend", backend,
                 "--devices", ",".join(devices)],
                stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    return scenario, procs, logs, time.perf_counter()


def wait_mesh_children(started: tuple) -> list:
    """Wait for the ranks ``start_mesh_children`` started, within
    ``MESH_CHILD_TIMEOUT`` of their start, and fail if any overruns or
    fails (every rank is then stopped); -> each rank's (json, arrays)."""
    scenario, procs, logs, t0 = started
    root, world = WORK / "mesh", len(procs)
    try:
        # every rank polled: one that fails stops the others at once (they
        # would otherwise wait in a collective until its timeout)
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise AssertionError(
                        f"mesh {scenario}: rank {r} exited {p.returncode}:\n"
                        + logs[r].read_text()[-6000:])
            if time.perf_counter() - t0 > MESH_CHILD_TIMEOUT:
                raise AssertionError(f"mesh {scenario}: the ranks overran "
                                     f"{MESH_CHILD_TIMEOUT} s")
            time.sleep(0.2)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(
                    f"mesh {scenario}: rank {r} exited {p.returncode}:\n"
                    + logs[r].read_text()[-6000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(world):
        print(logs[r].read_text()[-3000:] if r == 0 else "", end="")
    print(f"mesh {scenario}: {world} rank(s) ran in "
          f"{time.perf_counter() - t0:.1f} s from their start")
    return [(json.loads((root / f"{scenario}.rank{r}.json").read_text()),
             dict(np.load(root / f"{scenario}.rank{r}.npz")))
            for r in range(world)]


def mesh_nccl1(torch, models, cond, uncond, noise) -> dict:
    """Phase mesh's one rank over NCCL, in this process: a sum over the
    group, an 8-frame pndm-4 (``MESH_STEPS``) dispatch of phase 5's
    bundle on the one-rank mesh against a one-rank engine's, and a bf16
    UNet training step on it against the trainer without a mesh; -> its
    readings, frames and launches."""
    import torch.distributed as dist

    from stable_diffusion_videos_tpu_torch.parallel import \
        initialize_multihost
    from stable_diffusion_videos_tpu_torch.parallel.multihost import shutdown
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    from stable_diffusion_videos_tpu_torch.training import (TrainConfig,
                                                            UNetTrainer)
    mesh = initialize_multihost(f"localhost:{free_port()}", 1, 0,
                                backend="nccl", devices=["cuda:0"],
                                timeout_s=MESH_CHILD_TIMEOUT - 60)
    dev, out, keys = mesh.device, {"launches": {}, "seconds": {}}, []
    run = dict(num_inference_steps=MESH_STEPS, guidance_scale=7.5,
               output_dtype="uint8")

    def counted(name, fn, backward=False):
        got = []
        out["launches"][name], out["seconds"][name] = counted_run(
            torch, f"mesh nccl1: {name}", lambda: got.append(fn()),
            backward=backward, keys=keys)
        return got[0]
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        out["nccl_sum"] = t.tolist()
        plain = Engine(models, dev).denoise_frames(cond, uncond, noise, **run)
        pipe = StableDiffusionWalkPipeline(models, dev, mesh=mesh,
                                           safety=False)
        out["frames"] = counted("dispatch", lambda: pipe.engine
                                .denoise_frames(cond, uncond, noise, **run))
        out["equal"] = bool(np.array_equal(out["frames"], plain))
        del pipe
        # a training step on the one-rank mesh against the trainer without
        # one (cuDNN's deterministic algorithms, as phase train's
        # bit-equality checks use)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        rng = np.random.default_rng(32)
        lat = rng.standard_normal((2, 64, 64, 4), dtype=np.float32) * 0.5
        ctx = rng.standard_normal(
            (2, 77, models.unet_config.cross_attention_dim),
            dtype=np.float32) * 0.3
        cfg = TrainConfig(learning_rate=1e-4, ema_decay=0.999)
        alone = UNetTrainer(models, config=cfg, device=dev)
        counted("train_step_no_mesh", lambda: alone.step(lat, ctx),
                backward=True)
        want = [t.to("cpu", copy=True)
                for t in [*alone.weights.parameters(), *alone.ema_params]]
        del alone
        torch.cuda.empty_cache()
        meshed = UNetTrainer(models, mesh=mesh, config=cfg)
        counted("train_step", lambda: meshed.step(lat, ctx), backward=True)
        out["train_equal"] = all(torch.equal(a.cpu(), b) for a, b in zip(
            [*meshed.weights.parameters(), *meshed.ema_params], want))
        del meshed, want
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = cudnn
        shutdown()
        gc.collect()
        torch.cuda.empty_cache()
    out["keys"] = [(name, repr(k), n) for name, k, n in keys]
    return out


def mesh_addon_references(torch, root: Path, cond, uncond, noise) -> dict:
    """One rank's frames of phase mesh's add-on dispatches in this process
    (while the ranks run theirs): fp32 ddim-2 and bf16 pndm at
    ``MESH_STEPS``, each add-on on phase 5's bundle."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    dev, out = torch.device("cuda"), {}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        base = SDModels.load(root / "bundle", dtype=dtype, device=dev)
        parts = mesh_addon_parts(torch, dtype, dev)
        for addon in MESH_ADDONS:
            eng, extra = mesh_addon_engine(
                torch, base, parts, addon, dev,
                scheduler="ddim" if fp32 else "pndm")
            if fp32:
                out[f"{addon}32"] = eng.denoise_frames(
                    cond, uncond, noise, num_inference_steps=2,
                    guidance_scale=7.5, **extra)
            else:
                out[addon] = eng.denoise_frames(
                    cond, uncond, noise, num_inference_steps=MESH_STEPS,
                    guidance_scale=7.5, output_dtype="uint8", **extra)
            del eng, extra
        del base, parts
        torch.cuda.empty_cache()
    return out


def check_mesh_serving(name: str, ranks: list, what: str, line: str):
    """Phase mesh's serving and out-of-memory readings of both ranks,
    printed and held (see ``mesh_serving`` and ``mesh_oom_split``)."""
    s = ranks[0]["serve"]
    print(f"{name}: served from rank 0 over data 2 ({what}; not a scaling "
          f"figure), pndm-{MESH_STEPS}, 512²: /health mesh "
          f"{s['health_mesh']}; one /generate {s['one_s']:.4f} s, its PNG "
          f"bit-equal to one rank's generate(): {s['png_equal']}; 16 "
          f"concurrent /generate {s['merged_s']:.4f} s in dispatches of "
          f"{s['merged_sizes']}; a /walk job of 8 frames {s['walk_s']:.4f} s"
          f" ({s['walk_status']}, {s['walk_pngs']} PNGs, {s['walk_videos']} "
          f"video, written by rank 0: writers "
          f"{[r['serve']['writer'] for r in ranks]}); DELETE of a walk "
          f"{s['cancel_status']} in {s['cancel_s']:.4f} s after "
          f"{s['cancel_done']} frames, containers left {s['cancel_left']}; "
          f"a /generate after it: {s['after_cancel']} image; on {line}")
    if not (s["health_mesh"] == {"data": 2, "model": 1} and s["png_equal"]
            and s["merged_sizes"] == [16] and s["merged_ok"]
            and s["walk_status"] == "done" and s["walk_pngs"] == 8
            and s["walk_videos"] == 1 and s["cancel_status"] == "cancelled"
            and not s["cancel_left"] and s["after_cancel"] == 1
            and [r["serve"]["writer"] for r in ranks] == [True, False]):
        raise AssertionError(f"{name}: serving over the mesh failed: {s}")
    for r, res in enumerate(ranks):
        o = res["oom"]
        print(f"{name}: rank {r} out-of-memory split: reserved peaks "
              f"{ {b: round(v / 1e9, 3) for b, v in o['peaks'].items()} } GB"
              f" (allocated "
              f"{ {b: round(v / 1e9, 3) for b, v in o['allocated'].items()} }"
              f"; 8 / 16 frames, 4 / 8 rows a rank); cap search on rank 1 "
              f"(GB, the batches that ran out) {o['probes']}; under the cap "
              f"{o.get('splits')}, frames within {o.get('max_diff')}/255 of "
              f"the unsplit dispatch")
        if o["cap"] is None or not o.get("splits") or o["max_diff"] > 2:
            raise AssertionError(f"{name}: rank {r} did not split as agreed")
    print(f"{name}: the 16-frame pndm-{MESH_STEPS} dispatch split under "
          f"rank 1's cap in {ranks[0]['seconds']['oom_split']:.4f} s "
          f"(unsplit {ranks[0]['seconds']['dp_dispatch']:.4f}) on {line}")


def check_mesh_addons(name: str, ranks: list, arrays: list, ref: dict,
                      line: str):
    """Phase mesh's add-ons over model 2 against one rank's: fp32 frames at
    each layout's bound, bf16 at phase quality's, both ranks equal."""
    from stable_diffusion_videos_tpu_torch.utils.metrics import \
        quality_vs_exact
    for layout, tol in (("tp", MESH_TP_TOL), ("spatial", MESH_SPATIAL_TOL)):
        for addon in MESH_ADDONS:
            for r, arr in enumerate(arrays):
                got = arr[f"{addon}_{layout}_frames32"]
                print(f"{name}: rank {r} {addon} {layout} fp32 ddim-2 frames,"
                      f" max abs err {np.abs(got - ref[addon + '32']).max():.3e}"
                      f" against one rank")
                np.testing.assert_allclose(got, ref[addon + "32"], **tol)
            got = arrays[0][f"{addon}_{layout}_frames"]
            q = quality_vs_exact(got / 255.0, ref[addon] / 255.0,
                                 lpips_device="cpu")
            secs = ranks[0]["seconds"][f"{addon}_{layout}_bfloat16"]
            print(f"{name}: {addon} {layout} bf16 pndm-{MESH_STEPS} 8 "
                  f"frames {secs:.4f} s (rank 0; not a scaling figure); "
                  f"against one rank PSNR mean {q['psnr_mean']:.2f} dB (min "
                  f"{q['psnr_min']:.2f}), SSIM mean {q['ssim_mean']:.4f}; on "
                  f"{line}")
            if (q["psnr_mean"] < MESH_BF16_TOL["psnr_mean"]
                    or q["ssim_mean"] < MESH_BF16_TOL["ssim_mean"]
                    or not np.array_equal(got, arrays[1][
                        f"{addon}_{layout}_frames"])):
                raise AssertionError(f"{name}: {addon} {layout} is outside "
                                     f"{MESH_BF16_TOL} or its ranks differ")


def check_mesh_training(name: str, ranks: list, what: str, line: str):
    """Phase mesh's ``train`` readings of both ranks, printed and held to
    their bounds (see ``mesh_training``)."""
    r0, r1 = ranks
    g, tol = r0["fp32_gradient"], MESH_TRAIN_GRAD_TOL
    bound = MESH_TRAIN_ADAM_SHARE * 1e-4 * 2
    print(f"{name}: fp32 UNet (TF32 off) at 32² latents, global batch 4 (2 "
          f"a rank): the averaged gradient against one rank's on the whole "
          f"batch, cosine {g['cosine']:.9f}, max error {g['max_err']:.3e} of "
          f"the largest (bounds {tol}); its norm {g['norm']:.4e}, clipped "
          f"at {MESH_TRAIN_FP32_CLIP}; the masters after 2 steps "
          f"{r0['fp32_masters_max_diff']:.3e} from one rank's (bound "
          f"{bound:.1e}); replicas bit-equal: {r0['fp32_replicas_equal']}, "
          f"{r1['fp32_replicas_equal']}")
    if (g["cosine"] < tol["cosine"] or g["max_err"] > tol["max_err"]
            or g["norm"] <= MESH_TRAIN_FP32_CLIP
            or r0["fp32_masters_max_diff"] > bound
            or not (r0["fp32_replicas_equal"] and r1["fp32_replicas_equal"])):
        raise AssertionError(f"{name}: the fp32 data-parallel trainer is not "
                             f"one rank's")
    for run, what_run in (
            ("train_unet", "UNet, 64² latents, global batch 4, EMA"),
            ("train_lora", "LoRA rank 8, 64² latents, global batch 4"),
            ("train_vae", "VAE, 512², global batch 2"),
            ("train_lcm", "LCM distillation, 64² latents, global batch 4")):
        a, b = r0[run], r1[run]
        warm = a["seconds"][1:]
        print(f"{name}: {run} ({what_run}, bf16): losses "
              f"{[f'{x:.6f}' for x in a['losses']]}, equal on both ranks: "
              f"{a['losses'] == b['losses']}; replicas bit-equal after every "
              f"step: {a['replicas_equal']}, {b['replicas_equal']}; warm "
              f"step {min(warm):.4f} s (steps "
              f"{[f'{x:.4f}' for x in a['seconds']]}), all-reduce "
              f"{np.mean(a['reduce_ms'][1:]):.2f} ms a warm step (rank 0), "
              f"peak memory {a['peak_gib']:.2f} / {b['peak_gib']:.2f} GiB "
              f"(rank 0 / 1; {what}, not a scaling figure) on {line}")
        if not (np.isfinite(a["losses"]).all()
                and a["losses"] == b["losses"]
                and all(a["replicas_equal"]) and all(b["replicas_equal"])):
            raise AssertionError(f"{name}: {run}'s ranks differ or its "
                                 f"losses are not finite")
    print(f"{name}: seconds of each counted run (rank 0): "
          + ", ".join(f"{k} {v:.2f}" for k, v in r0["seconds"].items()))
    u = [r["train_unet"] for r in ranks]
    print(f"{name}: a checkpoint written by rank 0 after step 1 and restored "
          f"on both ranks: step {u[0]['restored_step']} restored, the step "
          f"after it bit-equal to the uninterrupted step 2: "
          f"{u[0]['resumed_equal']}, {u[1]['resumed_equal']} (restore and "
          f"step {u[0]['resume_seconds']:.2f} s; host memory available "
          f"then {u[0]['host_available']})")
    if not all(x["resumed_equal"] and x["restored_step"] == 1 for x in u):
        raise AssertionError(f"{name}: the restored run diverged")


def check_mesh_model_split(name: str, ranks: list, arrays: list,
                           line: str):
    """Phase mesh's out-of-memory split on the model axis, each layout,
    printed and held: both ranks split under rank 1's cap, once the groups
    were re-formed, the frames within 2/255 of the unsplit dispatch and
    equal on both ranks, and the dispatch after it bit-equal to the one
    before it (see ``mesh_oom_split``)."""
    for layout in ("tp", "spatial"):
        key = f"oom_{layout}"
        for r, res in enumerate(ranks):
            o = res[key]
            print(f"{name}: {layout} rank {r} out-of-memory split: reserved "
                  f"peaks "
                  f"{ {b: round(v / 1e9, 3) for b, v in o['peaks'].items()} }"
                  f" GB (allocated "
                  f"{ {b: round(v / 1e9, 3) for b, v in o['allocated'].items()} }"
                  f"; 4 / 8 frames); cap search on rank 1 (GB, the batches "
                  f"that ran out) {o['probes']}; under the cap "
                  f"{o.get('splits')}, frames within {o.get('max_diff')}/255 "
                  f"of the unsplit dispatch; the axis groups re-formed "
                  f"{o.get('reforms')} time(s), in "
                  f"{o.get('reform_seconds', 0.0):.3f} s the last; the "
                  f"dispatch after it bit-equal to the one before it: "
                  f"{o.get('after_equal')}")
            if (o["cap"] is None or not o.get("splits") or o["max_diff"] > 2
                    or o["reforms"] != 1 or not o["after_equal"]):
                raise AssertionError(f"{name}: {layout} rank {r} did not "
                                     f"split as agreed: {o}")
        if not np.array_equal(arrays[0][f"{key}_split"],
                              arrays[1][f"{key}_split"]):
            raise AssertionError(f"{name}: the ranks' {layout} split frames "
                                 f"differ")
        s = ranks[0]["seconds"]
        print(f"{name}: the 8-frame {layout} pndm-{MESH_STEPS} dispatch "
              f"split under rank 1's cap in {s[key]:.4f} s (unsplit "
              f"{s[f'{key}_before']:.4f} s, the same dispatch after the "
              f"split {s[f'{key}_after']:.4f} s), the ranks' frames equal, "
              f"on {line}")


def phase_mesh(torch, models):
    """The multi-card layer (``parallel/``) on phase 5's bundle at 512²,
    its ranks as child processes; -> {run: {kernel: launches}} of rank 0."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    from stable_diffusion_videos_tpu_torch.utils.metrics import \
        quality_vs_exact
    dev, line = torch.device("cuda"), gpu_line()
    root = WORK / "mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    models.save(root / "bundle")

    # the inputs, and the fp32 references of one rank in this process
    pipe = StableDiffusionWalkPipeline(models, dev, safety=False)
    cond, uncond, noise = dispatch_inputs(torch, pipe)
    # fp32 holds the bf16 embeddings exactly; the UNet casts them back
    np.savez(root / "inputs.npz", cond=cond.float().cpu().numpy(),
             uncond=uncond.float().cpu().numpy(), noise=noise.numpy())
    del pipe
    # the layouts' ranks start now: they set up while this process works
    layouts = [("gloo2", "gloo", ["cuda:0", "cuda:0"],
                "two ranks sharing one card over gloo, bytes by CUDA IPC")]
    if torch.cuda.device_count() >= 2:
        layouts.append(("nccl2", "nccl", ["cuda:0", "cuda:1"],
                        "two ranks on two cards over NCCL"))
    first = start_mesh_children(layouts[0][0], 2, *layouts[0][1:3])
    m32 = SDModels.load(root / "bundle", dtype=torch.float32, device=dev)
    e32 = Engine(m32, dev, scheduler="ddim", debug=True)
    frames32 = e32.denoise_frames(cond, uncond, noise, num_inference_steps=2,
                                  guidance_scale=7.5)
    lat32 = e32.debug_latents[-1].float().cpu().numpy()
    del e32, m32
    torch.cuda.empty_cache()

    # one NCCL rank in this process: its dispatch bit-equal to a one-rank
    # engine's, and the bf16 frames the sharded layouts are held to
    inp = np.load(root / "inputs.npz")
    nccl = mesh_nccl1(torch, models, *(torch.from_numpy(inp[k]) for k in (
        "cond", "uncond", "noise")))
    if nccl["nccl_sum"] != [1.0] * 4 or not nccl["equal"]:
        raise AssertionError("mesh: the one-rank NCCL dispatch differs from "
                             "a one-rank engine's")
    print(f"mesh nccl1: a bf16 UNet training step (batch 2, 64² latents, "
          f"EMA) on the one-rank mesh bit-equal to the trainer without a "
          f"mesh: {nccl['train_equal']}")
    if not nccl["train_equal"]:
        raise AssertionError("mesh: the one-rank NCCL training step differs "
                             "from the trainer's without a mesh")
    one = nccl["frames"]
    frames5 = one[:5].astype(np.float32) / 255.0
    checker = mesh_safety_checker(torch, frames5)
    with torch.no_grad():
        want_flags = Engine(models.with_safety_checker(checker),
                            dev).check_safety(frames5).cpu().tolist()
    torch.save(checker.state_dict(), root / "safety.pt")
    np.save(root / "frames5.npy", frames5)
    del checker
    torch.cuda.empty_cache()
    (root / "go").touch()
    # one rank's add-on frames, while the ranks run theirs
    addon_ref = mesh_addon_references(torch, root, *(
        torch.from_numpy(inp[k]) for k in ("cond", "uncond", "noise")))
    result = {f"nccl1_{run}": n for run, n in nccl["launches"].items()}
    keys = list(nccl["keys"])
    for scenario, backend, devices, what in layouts:
        started = (first if scenario == layouts[0][0] else
                   start_mesh_children(scenario, 2, backend, devices))
        (r0, a0), (r1, a1) = wait_mesh_children(started)
        # data parallel: each rank's rows bit-equal to a one-rank engine's
        # dispatch of them, the walk's PNGs to the dispatch
        if not (r0["dp_rows_equal"] and r1["dp_rows_equal"]
                and r0["walk_equal"]):
            raise AssertionError(f"mesh {scenario}: data-parallel frames "
                                 f"differ from one rank's: rows "
                                 f"{r0['dp_rows_equal']}, "
                                 f"{r1['dp_rows_equal']}, walk "
                                 f"{r0['walk_equal']}")
        if r0["video_frames"] != 16:
            raise AssertionError(f"mesh: rank 0's video has "
                                 f"{r0['video_frames']} frames")
        for res, r in zip((r0, r1), (0, 1)):
            keys += res["keys"]
            if res["flags"] != want_flags:
                raise AssertionError(f"mesh {scenario}: flags "
                                     f"{res['flags']} != {want_flags}")
            for dn in ("float32", "bfloat16"):
                held, want, params = res[f"tp_bytes_{dn}"]
                print(f"mesh {scenario}: rank {r}'s memory grew "
                      f"{held / 2**30:.4f} GiB when its {dn} TP engine "
                      f"loaded; its parameters {params / 2**30:.4f} GiB; the "
                      f"accounting {want / 2**30:.4f} GiB")
                if abs(held - want) > MESH_MEMORY_RTOL * want:
                    raise AssertionError("mesh: TP memory off the "
                                         "accounting")
        for layout, tol in (("tp", MESH_TP_TOL),
                            ("spatial", MESH_SPATIAL_TOL)):
            for r, arr in enumerate((a0, a1)):
                for kind, got, want in (
                        ("latents", arr[f"{layout}_latents"], lat32),
                        ("frames", arr[f"{layout}_frames32"], frames32)):
                    print(f"mesh {scenario}: rank {r} {layout} fp32 ddim-2 "
                          f"{kind}, max abs err "
                          f"{np.abs(got - want).max():.3e} against one rank")
                    np.testing.assert_allclose(got, want, **tol)
            q = quality_vs_exact(a0[f"{layout}_frames"] / 255.0, one / 255.0,
                                 lpips_device="cpu")
            print(f"mesh {scenario}: {layout} bf16 pndm-{MESH_STEPS} "
                  f"against one rank:"
                  f" PSNR mean {q['psnr_mean']:.2f} dB (min "
                  f"{q['psnr_min']:.2f}), SSIM mean {q['ssim_mean']:.4f}")
            if (q["psnr_mean"] < MESH_BF16_TOL["psnr_mean"]
                    or q["ssim_mean"] < MESH_BF16_TOL["ssim_mean"]
                    or not np.array_equal(a0[f"{layout}_frames"],
                                          a1[f"{layout}_frames"])):
                raise AssertionError(f"mesh {scenario}: {layout} is outside "
                                     f"{MESH_BF16_TOL} or its ranks differ")
        print(f"mesh {scenario}: an all-gather of (16, 320, 64, 32) bf16 "
              f"over 2 ranks, ms: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in r0["transport_ms"].items())
              + f" ({what}) on {line}")
        s = r0["seconds"]
        print(f"mesh {scenario} ({what}; not a scaling figure): dispatch "
              f"seconds, pndm-{MESH_STEPS}, 512²: one rank 8 frames "
              f"{nccl['seconds']['dispatch']:.3f}; "
              f"data parallel 16 frames {s['dp_dispatch']:.3f} (walk of 16 "
              f"with its first call {s['dp_walk']:.3f}); tensor parallel 8 "
              f"frames {s['tp_bfloat16']:.3f}; spatial 8 frames "
              f"{s['spatial_bfloat16']:.3f}; on {line}")
        check_mesh_serving(f"mesh {scenario}", [r0, r1], what, line)
        check_mesh_model_split(f"mesh {scenario}", [r0, r1], [a0, a1], line)
        check_mesh_addons(f"mesh {scenario}", [r0, r1], [a0, a1], addon_ref,
                          line)
        # then training over data 2: the four trainers' replicas
        check_mesh_training(f"mesh train_{scenario}", [r0, r1], what, line)
        result.update({(f"train_{scenario}_{run}" if run.startswith("train")
                        else f"{scenario}_{run}"): n
                       for run, n in r0["launches"].items()})
    checked = {name: {repr(k) for k in ks}
               for name, ks in checked_keys(torch).items()}
    unchecked = sorted({(n, k) for n, k, _ in keys if k not in checked[n]})
    if unchecked:
        raise AssertionError(f"phase 3 does not check the mesh runs' "
                             f"launches at {unchecked}")
    print(f"mesh: every launch key of every rank ({len(keys)} key counts) is "
          f"one phase 3 checks")
    shutil.rmtree(root / "bundle")
    return result


def host_available_gib() -> str:
    """The host's MemAvailable (``/proc/meminfo``), as "N.N GiB"."""
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return f"{int(line.split()[1]) / 2 ** 20:.1f} GiB"
    except OSError:
        pass
    return "unknown"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES}")
    # one rank of phase mesh's process group (phase_mesh starts them)
    ap.add_argument("--mesh-child", help=argparse.SUPPRESS)
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    ap.add_argument("--backend", help=argparse.SUPPRESS)
    ap.add_argument("--devices", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_child:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh_child(torch, args.mesh_child, args.rank, args.world, args.port,
                   args.backend, args.devices.split(","))
        return
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_env(torch)  # always: it refuses to go on without CUDA
    summary, launches, fewstep, distilled, families, edit, addons, post, \
        serve, train, quality, mesh = (None,) * 12
    frames, xl_parts, main_fps = None, None, None
    # the golden's weights and phase 5's bundle are drawn while nvcc builds
    # (on the host, and on the card, which nothing else uses then); both
    # are waited for before phase 3 times anything
    golden_drawn = (in_background(golden_weights)
                    if {"build", "golden"} <= set(phases) else None)
    golden_w, models = None, None
    models_drawn = (in_background(lambda: sd1_bundle(torch))
                    if {"main", "fewstep", "distilled", "edit", "addons",
                        "post", "serve", "train", "quality", "mesh"}
                    & set(phases) else None)
    t_all = time.perf_counter()
    for name in PHASES[1:]:
        if name not in phases:
            continue
        if name != "build" and models_drawn is not None:
            models, models_drawn = models_drawn(), None
        t0 = time.perf_counter()
        if name == "build":
            phase_build()
            if golden_drawn is not None:
                golden_w = golden_drawn()
        elif name == "kernels":
            summary = phase_kernels(torch)
        elif name == "golden":
            phase_golden(torch, golden_w)
            golden_w = None
        elif name == "main":
            launches, frames, main_fps = phase_main(torch, models)
        elif name == "fewstep":
            fewstep = phase_fewstep(torch, models)
        elif name == "distilled":
            distilled = phase_distilled(torch, models)
        elif name == "families":
            families, xl_parts = phase_families(torch)
        elif name == "edit":
            edit = phase_edit(torch, models, frames, xl_parts)
            xl_parts = None
        elif name == "addons":
            addons = phase_addons(torch, models, frames)
        elif name == "post":
            post = phase_post(torch, models, frames)
        elif name == "serve":
            serve = phase_serve(torch, models, frames, main_fps)
        elif name == "train":
            train = phase_train(torch, models, summary)
        elif name == "quality":
            quality = phase_quality(torch, models, frames)
        else:
            mesh = phase_mesh(torch, models)
        # on stderr too: a run stopped at a time limit shows how far it got
        done = (f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
                f"({time.perf_counter() - t_all:.1f} s in all; host memory "
                f"available {host_available_gib()})")
        print(done, flush=True)
        print(done, file=sys.stderr, flush=True)
    print(f"phases {','.join(p for p in PHASES[1:] if p in phases)}: ok in "
          f"{time.perf_counter() - t_all:.1f} s")
    if set(phases) != set(PHASES):
        print(f"partial run of {phases}: no result line")
        return
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "stable_diffusion_videos_tpu_torch/csrc/"
                   "flash_attention.cu",
         "replaces": "stable_diffusion_videos_tpu/ops/"
                     "flash_attention.py:137",
         "launches": launches["flash_attention"]},
        {"name": "groupnorm_silu", "route": "cuda",
         "source": "stable_diffusion_videos_tpu_torch/csrc/groupnorm.cu",
         "replaces": "stable_diffusion_videos_tpu/ops/groupnorm.py:74",
         "launches": launches["fused_groupnorm_silu"]}]
    wrapper = {"flash_attention": "flash_attention",
               "groupnorm_silu": "fused_groupnorm_silu",
               "groupnorm_stats": "groupnorm_partials",
               "groupnorm_apply": "groupnorm_apply",
               "flash_attention_bwd": "flash_attention_backward",
               "groupnorm_silu_bwd": "groupnorm_silu_backward"}
    for k in kernels:
        k["launches_train"] = {run: counts[wrapper[k["name"]]]
                               for run, counts in train.items()}
        k["launches_fewstep"] = {run: counts[wrapper[k["name"]]]
                                 for run, counts in fewstep.items()}
        k["launches_distilled"] = {run: counts[wrapper[k["name"]]]
                                   for run, counts in distilled.items()}
        k["launches_families"] = {run: counts[wrapper[k["name"]]]
                                  for run, counts in families.items()}
        k["launches_edit"] = {run: counts[wrapper[k["name"]]]
                              for run, counts in edit.items()}
        k["launches_addons"] = {run: counts[wrapper[k["name"]]]
                                for run, counts in addons.items()}
        k["launches_post"] = {run: counts[wrapper[k["name"]]]
                              for run, counts in post.items()}
        k["launches_serve"] = {run: counts[wrapper[k["name"]]]
                               for run, counts in serve.items()}
        k["launches_quality"] = {run: counts[wrapper[k["name"]]]
                                 for run, counts in quality.items()}
        k["launches_mesh"] = {run: counts[wrapper[k["name"]]]
                              for run, counts in mesh.items()}
    # the backward kernels have no Pallas counterpart: the JAX package's
    # trainers differentiate its XLA routes
    for name, source, replaces in (
            ("flash_attention_bwd", "attention_backward.cu",
             "XLA autodiff of stable_diffusion_videos_tpu/ops/"
             "attention.py:79 (xla_attention)"),
            ("groupnorm_silu_bwd", "groupnorm_backward.cu",
             "XLA autodiff of stable_diffusion_videos_tpu/models/"
             "layers.py:96 (flax nn.GroupNorm)")):
        runs = {run: counts[wrapper[name]] for run, counts in train.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": "stable_diffusion_videos_tpu_torch/csrc/"
                                  + source,
                        "replaces": replaces,
                        "launches": sum(runs.values()),
                        "launches_train": runs,
                        "launches_mesh": {
                            run: counts[wrapper[name]]
                            for run, counts in mesh.items() if "train" in run}})
    # the split-statistics GroupNorm: its main path is the spatially sharded
    # UNet, whose launches come from phase mesh's bf16 run (rank 0)
    for name, wrap, library in (
            ("groupnorm_stats", "groupnorm_partials", "torch.var_mean"),
            ("groupnorm_apply", "groupnorm_apply", None)):
        runs = {run: counts[wrap] for run, counts in mesh.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "stable_diffusion_videos_tpu_torch/csrc/groupnorm.cu",
            "replaces": "XLA SPMD partitioning of stable_diffusion_videos_tpu"
                        "/models/layers.py:96 (flax nn.GroupNorm) under "
                        "spatial_shard (stable_diffusion_videos_tpu/runtime/"
                        "engine.py:481)",
            "launches": runs["gloo2_spatial_bfloat16"],
            "launches_mesh": runs, "library": library})
    for k in kernels:
        s = summary[k["name"]]
        k.update(max_abs_err=s["err"], ms=s["ms"], plain_ms=s["plain_ms"],
                 bound_ms=s["bound_ms"],
                 bound_by=max(s["bound_by"], key=s["bound_by"].get),
                 library_ms=(None if k.get("library", "") is None
                             else s["library_ms"]))
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
