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
   planted faults.  Also the host time of a bf16 attention call's TMA
   tensor maps;
4. golden: the full-geometry SD 1.x UNet, VAE decoder and VAE encoder (its
   posterior's mean and log-variance) in fp32 (TF32 off) against
   ``tests/goldens/sd1_full_geometry.npz``, which the JAX package's
   reference produced;
5. main path: ``walk()`` at 512², pndm-50, CFG 7.5, batch 8, two dispatches,
   on random bf16 weights; the kernels' launch counts come from this run,
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
   weights (each bundle's build time printed): SDXL-base ``walk()`` at
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
10. addons: the conditioning add-ons on phase 5's bundle, pndm-50, CFG 7.5,
   batch 8, 512², each add-on drawn at its published widths (bf16 but the
   IP-Adapter's projection and image tower, fp32): a ControlNet
   (lllyasviel/sd-controlnet-canny's geometry) walk of 16 frames on one
   edge map and its warm dispatch beside a plain one (least of 2 each); one
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
   512², pndm-50, CFG 7.5, batch 8, with a safety checker at the geometry
   of CompVis/stable-diffusion-safety-checker (OpenAI ViT-L/14, bf16 tower,
   fp32 head) and a Real-ESRGAN x4plus RRDBNet (16.7M parameters), both
   drawn from numpy seeds, the net written as a ``.pth`` under
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
   = 2048, bf16).

Every failure raises, so the script exits non-zero.  The last two lines are
the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: scratch space inside the checkout (listed in .gitignore)
WORK = ROOT / "stable_diffusion_videos_tpu_torch" / "_build"
PHASES = ("env", "build", "kernels", "golden", "main", "fewstep",
          "distilled", "families", "edit", "addons", "post")
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


# Hopper instructions the kernels must contain: warpgroup MMA, TMA tensor
# loads, mbarrier syncs, register reallocation and cluster barriers
SASS_NEEDED = ("HGMMA", "UTMALDG", "SYNCS", "USETMAXREG", "UCGABAR_ARV")


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


def time_ms(torch, fn, warmup: int = 2, window_ms: float = 20.0) -> float:
    """Mean ms a call over back-to-back calls between two CUDA events: 5
    to 200 of them, as many as fill about window_ms (a call of tens of
    microseconds is otherwise read off a handful of launches)."""
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
            return e1.elapsed_time(e2) / reps
        cycles *= 2


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


def bound_ms(ops, nbytes, peak_ops) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def phase_kernels(torch):
    """Each kernel against its plain version, and its time beside the plain
    version's, one PyTorch library call's (the yardstick; the port never
    calls it) and the bound."""
    import torch.nn.functional as F

    from stable_diffusion_videos_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
        fused_groupnorm_silu, groupnorm_reference)
    from stable_diffusion_videos_tpu_torch.ops import build
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lib = build.library()
    summary = {name: dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                          bound_ms=0.0, bound_by={})
               for name in ("flash_attention", "groupnorm_silu")}
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
            ("post", POST_ATTN_SHAPES, []))}

    def record(name, key, text, dt, err, ms, pms, lms, bound):
        b_ms, b_by = bound
        print(f"{text}: max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
              f"{pms:.4f} ms library {lms:.4f} ms bound {b_ms:.4f} ms "
              f"({b_by}) share of bound {b_ms / ms:.3f}")
        s = summary[name]
        s["err"] = max(s["err"], err)
        if dt == torch.bfloat16:
            s["ms"] += ms
            s["plain_ms"] += pms
            s["library_ms"] += lms
            s["bound_ms"] += b_ms
            s["bound_by"][b_by] = s["bound_by"].get(b_by, 0.0) + b_ms
            for keys, sums in groups.values():
                if (*key, dt) in keys:
                    for field, value in (("ms", ms), ("plain_ms", pms),
                                         ("library_ms", lms),
                                         ("bound_ms", b_ms)):
                        sums[name][field] += value

    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        eb = torch.finfo(dt).bits // 8
        # the families', the edit paths' and the add-ons' rows in the walks'
        # dtype only
        shapes = ATTN_SHAPES + (FAMILY_ATTN_SHAPES + EDIT_ATTN_SHAPES
                                + ADDON_ATTN_SHAPES + POST_ATTN_SHAPES
                                if dt == torch.bfloat16 else [])
        for b, sq, sk, h, d in shapes:
            q = torch.randn(b, sq, h, d, device=dev, generator=g).to(dt)
            k = torch.randn(b, sk, h, d, device=dev, generator=g).to(dt)
            v = torch.randn(b, sk, h, d, device=dev, generator=g).to(dt)
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
        for shape, eps, silu, w_dt in (
                [(*c, dt) for c in GN_SHAPES]
                + [(*c, dt) for c in (FAMILY_GN_SHAPES + EDIT_GN_SHAPES
                                      if dt == torch.bfloat16 else [])]
                + [(*c, torch.float32) for c in GN_EXTRA]):
            x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.5).to(dt)
            scale = torch.randn(shape[1], device=dev, generator=g).to(w_dt)
            bias = torch.randn(shape[1], device=dev, generator=g).to(w_dt)
            name = (f"groupnorm {dn} {shape} eps={eps} silu={silu} weights "
                    f"{str(w_dt).split('.')[1]}")
            err = compare(torch, name,
                          fused_groupnorm_silu(x, scale, bias, 32, eps, silu),
                          groupnorm_reference(x, scale, bias, 32, eps, silu),
                          dn)
            ms = time_ms(torch, lambda: fused_groupnorm_silu(
                x, scale, bias, 32, eps, silu))
            pms = time_ms(torch, lambda: groupnorm_reference(
                x, scale, bias, 32, eps, silu))
            # the library call takes its weights in x's dtype
            sx, bx = scale.to(dt), bias.to(dt)
            lms = time_ms(torch, (lambda: F.silu(F.group_norm(
                x, 32, sx, bx, eps))) if silu else (lambda: F.group_norm(
                    x, 32, sx, bx, eps)))
            group_mb = np.prod(shape[1:]) // 32 * eb / 1e6
            record("groupnorm_silu", (shape, eps, silu),
                   f"{name} ({group_mb:.1f} MB a group)", dt, err, ms, pms,
                   lms, gn_bound(shape, silu, eb))
            del x
        torch.cuda.empty_cache()
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


def phase_golden(torch):
    from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                               UNetConfig)
    from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                              VAEConfig)
    from stable_diffusion_videos_tpu_torch.models.weights import \
        load_state_dict
    gold = np.load(ROOT / "tests" / "goldens" / "sd1_full_geometry.npz",
                   allow_pickle=False)
    dev = torch.device("cuda")

    def build(cls, cfg, manifest_key):
        shapes = json.loads(str(gold[manifest_key]))
        with torch.device("meta"):
            mod = cls(cfg)
        sd = {k: synth_value(k, tuple(s)) for k, s in shapes.items()}
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
    decoder at its published geometry, on the card."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    t0 = time.perf_counter()
    models = SDModels.random("sd1", seed=1, dtype=torch.bfloat16,
                             taesd=True).to(torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"random SD 1.x bundle built in {time.perf_counter() - t0:.1f} s")
    return models


def counted_run(torch, label: str, run):
    """Call ``run()`` with every launch counter and plain-version counter
    set to 0 just before, read them just after, and fail unless both
    kernels launched, no plain version ran, and phase 3 checks every
    (shape, dtype) key launched.  -> ({kernel: launches}, wall seconds)."""
    from stable_diffusion_videos_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
        fused_groupnorm_silu, groupnorm_reference)
    counters = (flash_attention, fused_groupnorm_silu)
    plains = (flash_attention_reference, groupnorm_reference)
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
    if min(launches.values()) <= 0 or max(plain_calls.values()) != 0:
        raise AssertionError(f"{label} did not run on the kernels alone")
    bf16 = torch.bfloat16
    checked = ({(*s, bf16) for s in ATTN_SHAPES + FAMILY_ATTN_SHAPES
                + EDIT_ATTN_SHAPES + ADDON_ATTN_SHAPES + POST_ATTN_SHAPES}
               | {(*c, bf16, bf16) for c in GN_SHAPES + FAMILY_GN_SHAPES
                  + EDIT_GN_SHAPES})
    unchecked = [k for counts in by_shape.values() for k in counts
                 if k not in checked]
    if unchecked:
        raise AssertionError(f"phase 3 does not check the launches of "
                             f"{label} at {unchecked}")
    return launches, seconds


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
    return launches, frames


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
    """A random bf16 bundle of ``family`` at its published widths, on the
    card, with its build time printed."""
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    t0 = time.perf_counter()
    models = SDModels.random(family, seed=seed, dtype=torch.bfloat16).to(
        torch.device("cuda"))
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
    warm, times = warm_seconds(torch, lambda: eng.denoise_frames(
        output_dtype="uint8", **xl_in))
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
    warm, times = warm_seconds(torch, lambda: pipe.engine.denoise_frames(
        cond, uncond, noise, num_inference_steps=50, guidance_scale=7.5,
        output_dtype="uint8"))
    print(f"families: SD 2.1 768-v warm dispatch of 8 frames at 768², "
          f"ddim-50 v-prediction CFG 7.5: {warm:.4f} s (min of {times}), "
          f"{8 / warm:.4f} frames/s, on {line}")
    del pipe, sd2
    torch.cuda.empty_cache()
    return out, xl_parts


def refiner_bundle(torch, xl_parts=None, seed: int = 4):
    """The random bf16 SDXL-refiner bundle at its published widths on the
    card: its UNet drawn, with phase 8's SDXL VAE and bigG tower (the same
    published geometry) when given, else the whole bundle drawn."""
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
        models = SDModels.random("sdxl_refiner", seed=seed, dtype=bf16)
    else:
        cfg = UNetConfig.sd_xl_refiner()
        with torch.device("meta"):
            unet = UNet2DCondition(cfg)
        load_state_dict(unet, random_state_dict(unet, seed, 0.02, bf16), bf16)
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
    """float32 arrays -> a ``.safetensors`` file (8-byte little-endian
    header length, JSON header, raw little-endian data): the card's machine
    has no safetensors package, and the port reads the format itself."""
    header, blobs, offset = {}, [], 0
    for name, value in tensors.items():
        blob = np.ascontiguousarray(value, "<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(value.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


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
    """Warm seconds of each ``{label: dispatch}``, timed in turns a, b, a,
    b (one call each after one warming call): -> {label: least}."""
    least = {}
    for label in (*dispatches, *dispatches):
        warm, _ = warm_seconds(torch, dispatches[label], runs=1,
                               warmed=label in least)
        least[label] = min(least.get(label, warm), warm)
    return least


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
    run = dict(num_inference_steps=50, guidance_scale=7.5)

    def nets(seed):
        t0 = time.perf_counter()
        cn = ControlNetBundle.random(seed=seed, dtype=bf16).to(dev)
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
            pipe, "chip_smoke_cn", 50, control_image=edge))
    check_pngs(WORK / "chip_smoke_cn", 16)
    cond, uncond, noise = dispatch_inputs(torch, pipe)
    timed = in_turns(torch, {
        label: (lambda kw=kw: pipe.engine.denoise_frames(
            cond, uncond, noise, output_dtype="uint8", **run, **kw))
        for label, kw in (("plain", {}), ("ControlNet", dict(control=edge)))})
    print(f"addons: ControlNet walk of 16 frames {walk_s:.3f} s (first "
          f"dispatch included); warm dispatch of 8 frames, pndm-50 CFG 7.5, "
          f"least of 2 in turns: ControlNet {timed['ControlNet']:.4f} s, "
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
            pipe, "chip_smoke_cn_zero", 50, control_image=edge))
    walk_clip(pipe, "chip_smoke_cn_plain", 50)
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
                          vision=CLIPVisionConfig.vit_h14())
    n = sum(p.numel() for p in ip.image_encoder.parameters())
    print(f"addons: random IP-Adapter (tower {n / 1e9:.3f}B parameters, "
          f"fp32) built in {time.perf_counter() - t0:.1f} s")
    image = frames[3]
    with torch.no_grad():
        pix = preprocess_clip_image(torch.from_numpy(image[None] / 255.0),
                                    224)
        emb_cpu = ip.image_encoder(pix.float())
        tok_cpu = ip.image_tokens(image)
        ip.to(dev)
        emb = ip.image_encoder(pix.float().to(dev)).cpu()
        tok = ip.image_tokens(image)
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
            ipipe, "chip_smoke_ip", 50, ip_image=image))
    check_pngs(WORK / "chip_smoke_ip", 16)
    timed = in_turns(torch, {
        label: (lambda eng=eng, kw=kw: eng.denoise_frames(
            cond, uncond, noise, output_dtype="uint8", **run, **kw))
        for label, eng, kw in (("plain", plain, {}),
                               ("IP-Adapter", ipipe.engine,
                                dict(ip_tokens=tok)))})
    print(f"addons: IP-Adapter walk of 16 frames {walk_s:.3f} s (first "
          f"dispatch included); warm dispatch of 8 frames, least of 2 in "
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
            wpipe, "chip_smoke_weighted", 50,
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
          f"dispatch included); warm dispatch of 8 frames, least of 2 in "
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
    checker = SafetyChecker.random(scfg, seed=7, std=0.02)
    ssd = {k: v.clone() for k, v in checker.state_dict().items()}
    n = sum(p.numel() for p in checker.parameters())
    print(f"post: random safety checker ({n / 1e9:.3f}B parameters) built "
          f"in {time.perf_counter() - t0:.1f} s")
    pix = preprocess_for_safety(torch.from_numpy(synth[:2] / 255.0).float(),
                                224)
    card = SafetyChecker.build(scfg, ssd, f32).to(dev)
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
    run = dict(num_inference_steps=50, guidance_scale=7.5,
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
        print(f"post: warm dispatch of 8 frames, pndm-50 CFG 7.5, least of "
              f"2 in turns: {label} {timed[label]:.4f} s, plain "
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
                   num_inference_steps=50, guidance_scale=7.5, batch_size=8,
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES}")
    phases = ap.parse_args().phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_env(torch)  # always: it refuses to go on without CUDA
    summary, launches, fewstep, distilled, families, edit, addons, post = \
        (None,) * 8
    frames, xl_parts = None, None
    models = (sd1_bundle(torch)
              if {"main", "fewstep", "distilled", "edit", "addons", "post"}
              & set(phases) else None)
    for name in PHASES[1:]:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        if name == "build":
            phase_build()
        elif name == "kernels":
            summary = phase_kernels(torch)
        elif name == "golden":
            phase_golden(torch)
        elif name == "main":
            launches, frames = phase_main(torch, models)
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
        else:
            post = phase_post(torch, models, frames)
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
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
               "groupnorm_silu": "fused_groupnorm_silu"}
    for k in kernels:
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
        s = summary[k["name"]]
        k.update(max_abs_err=s["err"], ms=s["ms"], plain_ms=s["plain_ms"],
                 bound_ms=s["bound_ms"],
                 bound_by=max(s["bound_by"], key=s["bound_by"].get),
                 library_ms=s["library_ms"])
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
