"""The denoise engine: CFG denoise loop plus VAE decode per dispatch.

Counterpart of ``stable_diffusion_videos_tpu/runtime/engine.py`` for the SD
1.x, SD 2.x and SDXL-base bundles: text embedding with an LRU cache (SDXL:
both towers' penultimate states concatenated, and tower 2's pooled output
for text_time), host-built scheduler tables,
a CFG loop over the sampler's steps (the JAX package's ``lax.scan`` as a
Python loop; PyTorch enqueues the kernels asynchronously), DeepCache step
caching and limited-interval CFG (``lax.cond`` and the scan's segments as
host decisions: no step reads anything back from the device), the decode
with on-device uint8 quantisation, and batch-bucket padding.  The stochastic
samplers draw their transition noise on the device from a
``torch.Generator`` (one field broadcast over the batch under
``frozen_noise``); the decode is the KL decoder, whole or in overlapping
tiles (``vae_tile``), or the TAESD tiny decoder (``tiny_decoder``).  An
SDXL dispatch carries its added conditions (the CFG-stacked pooled
embeddings and the size/crop time ids) beside the context, sliced to their
cond half wherever the context is.  The boundary keeps the JAX package's
layout: noise in ``(B, h, w, 4)``, frames out ``(B, H, W, 3)``.

The edit paths: ``encode_image`` (the KL encoder's scaled mean, whole or in
overlapping tiles blended on the device), ``img2img`` (the schedule entered
mid-way: the warm-up samplers' tables rebuilt from the entry, the others'
sliced on a copy) and ``inpaint`` (the known region put back at each step's
post-step noise level).  The SDXL refiner conditions on its one tower
(bigG) and takes 5 time ids with the aesthetic score.

The conditioning add-ons: ControlNet (one or several nets, their residuals
summed each step, ``guess_mode`` steering the cond half only; not with step
caching), IP-Adapter (its projections spliced into a copy of the UNet, the
image tokens CFG-stacked beside the context, the uncond half the projection
of a zero embedding, ``ip_scale`` 0 when a dispatch has no image) and
weighted prompts (``embed_text_weighted``: emphasis syntax and 77·n-token
contexts).

``check_safety``: the bundle's NSFW safety checker on frames in [0, 1], on
the engine's device, in the bundle's dtype.

Serving: ``denoise_frames_device`` (and the blocking ``denoise_frames``)
split a batch in half and retry each half when the card runs out of memory,
so a merged batch degrades to smaller dispatches instead of failing;
``warmup`` runs one dispatch a (batch, output dtype) at zero inputs under a
named sampler, leaving the engine's own sampler as it is.

Options of the JAX engine that this port does not have yet are refused when
set, never ignored (``UNPORTED``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..core.prompt_weighting import apply_token_weights, encode_weighted
from ..core.schedulers import get_scheduler
from ..core.schedulers.base import transition_noise
from ..models.bundle import SDModels
from ..models.layers import make_circular
from ..models.safety import preprocess_for_safety

logger = logging.getLogger("sdv_torch")

#: JAX Engine options this port does not have yet
UNPORTED = ("mesh", "spatial_shard", "debug")
#: samplers whose tables carry a multistep warm-up: img2img rebuilds their
#: tables from the entry index instead of slicing them
WARMUP_SAMPLERS = ("pndm", "lms", "unipc")
#: samplers whose latents live in sigma space (noised as x + sigma·noise)
SIGMA_SAMPLERS = ("euler", "euler_ancestral", "lms")
#: the refiner's aesthetic-score time id on the uncond and the cond rows
REFINER_AESTHETIC = (2.5, 6.0)

#: the stochastic samplers' noise source: a generator on the engine's
#: device, or a callable ``(i, latents) -> field`` that replaces the draws
NoiseSource = Union[torch.Generator,
                    Callable[[int, torch.Tensor], torch.Tensor]]


def refuse_unported(owner: str, allowed: tuple, options: dict) -> None:
    """Raise for any option in ``options``: ``NotImplementedError`` for a
    known, not yet ported one that is set, ``TypeError`` for an unknown
    name.  A known option left at None/False passes."""
    for name, value in options.items():
        if name not in allowed:
            raise TypeError(f"{owner}() got an unexpected argument {name!r}")
        if value is not None and value is not False:
            raise NotImplementedError(f"{owner}({name}=...) is not ported "
                                      "to the PyTorch package yet")


def is_out_of_memory(err: BaseException) -> bool:
    """Whether ``err`` is the card running out of memory: the caching
    allocator's ``OutOfMemoryError``, or cuBLAS and cuDNN failing to
    allocate their workspace, which they report as a plain
    ``RuntimeError``."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(err, RuntimeError) and any(
        code in str(err) for code in ("CUBLAS_STATUS_ALLOC_FAILED",
                                      "CUDNN_STATUS_ALLOC_FAILED"))


def batch_part(x, rows: int, sl: slice):
    """``x`` cut to the rows ``sl`` when it is batch-aligned (an array or
    tensor of two or more axes and ``rows`` rows), recursing into lists and
    tuples (several ControlNets' maps); anything else (scalars, a noise
    source, a broadcast row) as it is."""
    if isinstance(x, (list, tuple)):
        return type(x)(batch_part(e, rows, sl) for e in x)
    if hasattr(x, "shape") and len(x.shape) >= 2 and x.shape[0] == rows:
        return x[sl]
    return x


def apply_guidance(eps_u: torch.Tensor, eps_c: torch.Tensor, guidance: float,
                   rescale: float = 0.0) -> torch.Tensor:
    """Classifier-free-guidance combine, optionally std-rescaled toward the
    conditional branch's per-sample std (Lin et al. 2024 §3.4)."""
    eps = eps_u + guidance * (eps_c - eps_u)
    if rescale > 0.0:
        dims = tuple(range(1, eps.ndim))
        std_c = eps_c.std(dim=dims, keepdim=True, correction=0)
        std_cfg = eps.std(dim=dims, keepdim=True, correction=0)
        eps = rescale * (eps * std_c / (std_cfg + 1e-8)) \
            + (1.0 - rescale) * eps
    return eps


class Engine:
    def __init__(self, models: SDModels, device: torch.device,
                 scheduler: str = "pndm", batch_bucket: Optional[int] = None,
                 step_cache: Optional[int] = None, step_cache_split: int = 1,
                 step_cache_policy: str = "uniform",
                 guidance_rescale: float = 0.0,
                 guidance_interval: Optional[tuple] = None,
                 frozen_noise: bool = False, tiny_decoder: bool = False,
                 vae_tile: Optional[int] = None, vae_tile_overlap: int = 16,
                 controlnet=None, ip_adapter=None, **unported):
        refuse_unported("Engine", UNPORTED, unported)
        if models.is_xl and models.unet_config.addition_num_ids not in (5, 6):
            raise ValueError("text_time takes 6 ids (SDXL-base) or 5 (the "
                             "refiner), got "
                             f"{models.unet_config.addition_num_ids}")
        if tiny_decoder and models.taesd_decoder() is None:
            raise ValueError(
                "tiny_decoder=True requires TAESD weights on the bundle: "
                "models = models.with_taesd(config, state_dict); see "
                "models/taesd.py")
        if vae_tile is not None and not 0 <= vae_tile_overlap < vae_tile:
            raise ValueError("vae_tile_overlap must be in [0, vae_tile)")
        if step_cache is not None and step_cache < 1:
            raise ValueError("step_cache must be >= 1 (None = off)")
        if step_cache_policy not in ("uniform", "ends"):
            raise ValueError("step_cache_policy must be 'uniform' or 'ends'")
        if not 0.0 <= guidance_rescale <= 1.0:
            raise ValueError("guidance_rescale must be in [0, 1]")
        if guidance_interval is not None:
            lo, hi = (float(guidance_interval[0]),
                      float(guidance_interval[1]))
            if not 0.0 <= lo <= hi <= 1.0:
                raise ValueError("guidance_interval must satisfy "
                                 "0 <= lo <= hi <= 1")
            guidance_interval = (lo, hi) if (lo, hi) != (0.0, 1.0) else None
        self.device = torch.device(device)
        #: the bundle's modules are moved to ``device`` in place
        models = models.to(self.device)
        #: IP-Adapter image prompting (``models/ip_adapter.py``): its K/V
        #: projections spliced into a copy of the UNet that shares every
        #: other weight, its projection and tower moved to ``device``
        self.ip = ip_adapter
        if ip_adapter is not None:
            self.ip = ip_adapter.to(self.device)
            models = ip_adapter.splice(models)
        self.models = models
        #: ControlNet bundles (a list for multi-ControlNet), moved to
        #: ``device`` and cast to the UNet's dtype in place: dispatches with
        #: ``control=`` run each net's trunk a step and add the summed
        #: residuals to the UNet's skips
        if controlnet is not None and not isinstance(controlnet,
                                                     (list, tuple)):
            controlnet = [controlnet]
        self.controlnet = list(controlnet) if controlnet else None
        for cn in self.controlnet or ():
            if cn.pixel_factor != models.vae_scale_factor:
                raise ValueError(
                    f"ControlNet conditioning embedding downsamples "
                    f"{cn.pixel_factor}x but the VAE factor is "
                    f"{models.vae_scale_factor}x")
            if (cn.config.cross_attention_dim
                    != models.unet_config.cross_attention_dim):
                raise ValueError("ControlNet cross_attention_dim does not "
                                 "match the bundle's UNet")
            cn.module.to(device=self.device, dtype=models.dtype)
            if models.tiled:
                make_circular(cn.module)
        self.scheduler_name = scheduler
        self.sched = get_scheduler(scheduler)
        #: dispatch batches are padded up to a multiple of this
        self.batch_bucket = batch_bucket or 1
        #: DeepCache step caching: the deep UNet trunk is recomputed every
        #: ``step_cache`` steps and spliced into shallow passes in between;
        #: ``step_cache_split`` is the level it is cached at
        self.step_cache = step_cache
        self.step_cache_split = step_cache_split
        #: "uniform": a full trunk every k-th step of a segment; "ends": the
        #: same budget placed densest at the segment's ends
        self.step_cache_policy = step_cache_policy
        self.guidance_rescale = float(guidance_rescale)
        #: limited-interval CFG (Kynkäänniemi et al. 2024): the CFG pair
        #: runs for loop fractions in [lo, hi), the cond branch alone (half
        #: the UNet rows) outside; (0, 1) or None = CFG everywhere
        self.guidance_interval = guidance_interval
        #: the stochastic samplers (lcm, euler_ancestral, ddim with eta > 0)
        #: draw one transition-noise field a step and broadcast it over the
        #: batch: a walk dispatch holds adjacent frames of one trajectory,
        #: where independent per-frame noise reads as flicker
        self.frozen_noise = bool(frozen_noise)
        #: decode through the TAESD tiny decoder instead of the KL decoder
        self.tiny_decoder = bool(tiny_decoder)
        #: decode the KL decoder in overlapping latent tiles of this side
        #: (None: whole frames); the tiny decoder always decodes whole
        self.vae_tile = vae_tile
        self.vae_tile_overlap = vae_tile_overlap
        self._lock = threading.Lock()
        #: (sampler, batch, latent h, w, steps, output dtype) of each
        #: dispatch ``warmup`` ran
        self.warmed: set = set()
        self._tables_cache: dict = {}
        #: prompt tuple -> (hidden states, pooled output or None)
        self._embed_cache: "OrderedDict[tuple, tuple]" = OrderedDict()

    def set_scheduler(self, name: str) -> None:
        """Switch the sampler on a live engine.  Tables are keyed by sampler
        name (and eta), so they survive the switch; a dispatch reads (name,
        sampler) once under the lock and finishes on that sampler."""
        if name == self.scheduler_name:
            return
        sched = get_scheduler(name)  # raises KeyError before any change
        with self._lock:
            self.scheduler_name, self.sched = name, sched

    # ------------------------------------------------------------------
    # text embedding
    # ------------------------------------------------------------------
    def embed_text(self, text) -> torch.Tensor:
        """Prompt(s) -> (B, 77, D) hidden states on the device.  For an SDXL
        bundle D is the two towers' concatenation (768 + 1280), in fp32;
        for the refiner tower 2's alone (1280)."""
        return self._embed(text)[0]

    def embed_text_pooled(self, text) -> torch.Tensor:
        """SDXL: prompt(s) -> (B, Dp) projected pooled embedding of tower
        2, the text half of the text_time conditioning."""
        pooled = self._embed(text)[1]
        if pooled is None:
            raise ValueError("pooled embeddings require an SDXL bundle "
                             "(text_config_2)")
        return pooled

    @torch.no_grad()
    def _embed(self, text) -> tuple:
        """Prompt(s) -> (hidden states, pooled output or None), cached.
        With a second tower the pooled output is tower 2's, and the towers'
        states concatenate where the UNet's context is as wide as both
        (SDXL-base); otherwise (the refiner) tower 2's states alone are the
        context."""
        key = (text,) if isinstance(text, str) else tuple(text)
        with self._lock:
            if key in self._embed_cache:
                self._embed_cache.move_to_end(key)
                return self._embed_cache[key]
        m = self.models
        ids2 = (None if m.text_encoder_2 is None else
                (m.tokenizer_2 or m.tokenizer)(list(key))["input_ids"])
        out = self._encode_ids(m.tokenizer(list(key))["input_ids"], ids2)
        self._cache_embedding(key, out)
        return out

    def _encode_ids(self, ids, ids2=None) -> tuple:
        """Token ids of the tower(s) -> (hidden states, pooled output or
        None): tower 1 alone, both concatenated (SDXL-base), or tower 2
        alone (the refiner), as ``_embed`` describes."""
        m = self.models

        def dev(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.long,
                                   device=self.device)

        if m.text_encoder_2 is None:
            return m.text_encoder(dev(ids))[0], None
        h2, pooled = m.text_encoder_2(dev(ids2))
        dual = (m.unet_config.cross_attention_dim
                == m.text_config.hidden_size + m.text_config_2.hidden_size)
        if not dual:
            return h2.float(), pooled
        h1 = m.text_encoder(dev(ids))[0]
        return torch.cat([h1.float(), h2.float()], dim=-1), pooled

    def _cache_embedding(self, key, out) -> None:
        with self._lock:
            self._embed_cache[key] = out
            self._embed_cache.move_to_end(key)
            self._evict_embed_cache()

    @torch.no_grad()
    def embed_text_weighted(self, text, num_chunks: Optional[int] = None
                            ) -> torch.Tensor:
        """Prompt(s) with A1111/compel emphasis syntax -> (B, 77·n, D)
        float32 on the device (``core/prompt_weighting.py``): n 77-token
        windows, each window's hidden states weighted (mean-preserving) and
        the windows concatenated along the sequence.  ``num_chunks`` forces
        n, so that the cond and uncond contexts of one CFG dispatch agree;
        an SDXL bundle encodes its second tower at the same n.  A short
        prompt without weights gives ``embed_text``'s values."""
        texts = [text] if isinstance(text, str) else list(text)
        key = ("__weighted__", num_chunks, *texts)
        with self._lock:
            if key in self._embed_cache:
                self._embed_cache.move_to_end(key)
                return self._embed_cache[key]
        m = self.models
        tok, tok2 = m.tokenizer, m.tokenizer_2 or m.tokenizer
        enc = [encode_weighted(tok, t, num_chunks=num_chunks) for t in texts]
        n = max(ids.shape[0] for ids, _ in enc)
        enc = [(ids, w) if ids.shape[0] == n
               else encode_weighted(tok, t, num_chunks=n)
               for (ids, w), t in zip(enc, texts)]
        ids2 = (np.concatenate([encode_weighted(tok2, t, num_chunks=n)[0]
                                for t in texts])
                if m.text_encoder_2 is not None else None)
        h, _ = self._encode_ids(np.concatenate([i for i, _ in enc]), ids2)
        h = apply_token_weights(h, np.concatenate([w for _, w in enc]))
        out = h.reshape(len(texts), n * h.shape[1], h.shape[2])
        self._cache_embedding(key, out)
        return out

    def _evict_embed_cache(self):
        """LRU eviction (caller holds the lock) that never drops ("",), the
        uncond key of every CFG dispatch."""
        while len(self._embed_cache) > 256:
            for old in self._embed_cache:
                if old != ("",):
                    del self._embed_cache[old]
                    break
            else:
                break

    # ------------------------------------------------------------------
    # the denoise program
    # ------------------------------------------------------------------
    def _tables(self, sched_name: str, sched, num_inference_steps: int,
                eta: float, start_index: int = 0):
        """The sampler's tables, cached by (name, steps, eta) and, for a
        warm-up sampler's mid-schedule entry, ``start_index``.  Cached
        tables are shared: nothing may change them in place."""
        key = (sched_name, num_inference_steps, float(eta))
        if start_index:
            key += (start_index,)
        with self._lock:
            if key not in self._tables_cache:
                kwargs = {"eta": float(eta)} if sched_name == "ddim" else {}
                if start_index:
                    kwargs["start_index"] = start_index
                self._tables_cache[key] = sched.make_tables(
                    self.models.scheduler_config, num_inference_steps,
                    **kwargs)
            return self._tables_cache[key]

    def _entry_tables(self, sched_name: str, sched, num_inference_steps: int,
                      eta: float, strength: float) -> tuple:
        """img2img's schedule from ``strength``: -> (full tables, tables of
        the steps that run, k0).  ``k0`` rounds half to even (Python's
        ``round``), over the plain step count for the warm-up samplers,
        whose tables are rebuilt from the entry (pndm's loop has one more
        step than the schedule), and over the loop's steps for the others,
        whose tables are sliced.  The tables that run are a new dict with
        ``init_noise_sigma`` 1: the caller noises the latents itself."""
        tables = self._tables(sched_name, sched, num_inference_steps, eta)
        if sched_name in WARMUP_SAMPLERS:
            k0 = min(num_inference_steps - 1,
                     round(num_inference_steps * (1.0 - strength)))
            run = dict(self._tables(sched_name, sched, num_inference_steps,
                                    eta, start_index=k0))
        else:
            n_loop = sched.num_loop_steps(tables)
            k0 = min(n_loop - 1, round(n_loop * (1.0 - strength)))
            run = {k: (v[k0:] if isinstance(v, np.ndarray) and v.ndim
                       and v.shape[0] in (n_loop, n_loop + 1) else v)
                   for k, v in tables.items()}
            if sched_name == "dpm":
                # the first step that runs has no model-output history
                run["first_order"] = run["first_order"].copy()
                run["first_order"][0] = True
                run["h0"] = run["h0"].copy()
                run["h0"][0] = 1.0
        run["init_noise_sigma"] = np.float32(1.0)
        return tables, run, k0

    def _interval_segments(self, n_loop: int):
        """[(start, stop, cfg_on)] loop segments implementing
        ``guidance_interval``: CFG only where the loop fraction is in
        [lo, hi)."""
        if self.guidance_interval is None:
            return [(0, n_loop, True)]
        lo, hi = self.guidance_interval
        i0, i1 = int(round(lo * n_loop)), int(round(hi * n_loop))
        segs = [(0, i0, False), (i0, i1, True), (i1, n_loop, False)]
        return [(a, b, c) for a, b, c in segs if b > a]

    @staticmethod
    def _full_trunk_mask(segments, n_loop: int, k: int) -> np.ndarray:
        """Boolean (n_loop,) mask of the full-trunk steps of the "ends"
        policy: ceil(len/k) a segment, as uniform-k spends, placed at
        f(u) = u - sin(2πu)/2π of an even grid, so dense at both ends.  A
        segment's first step is always full (f(0) = 0)."""
        mask = np.zeros(n_loop, bool)
        for a, b, _cfg in segments:
            ln = b - a
            m = -(-ln // k)
            if m >= ln:
                mask[a:b] = True
                continue
            u = np.linspace(0.0, 1.0, m, endpoint=False)
            warped = u - np.sin(2.0 * np.pi * u) / (2.0 * np.pi)
            idx = set(np.minimum(a + np.floor(warped * ln).astype(int),
                                 b - 1).tolist())
            # rounding collisions: top up to the budget with the unused
            # indices nearest a segment end
            spare = sorted((i for i in range(a, b) if i not in idx),
                           key=lambda i: min(i - a, b - 1 - i))
            for i in spare[:m - len(idx)]:
                idx.add(i)
            mask[sorted(idx)] = True
        return mask

    def _decode(self, lat: torch.Tensor, out_u8: bool) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> (B, H, W, 3) frames in [0, 1]: the
        KL decoder (divided by the scaling factor first, output mapped from
        [-1, 1]) or the tiny decoder (takes the scaled latents, emits
        [0, 1]), clipped in fp32, and with ``out_u8`` rounded and quantised
        on the device."""
        if self.tiny_decoder:
            imgs = self.models.taesd.decode(lat).float()
        else:
            scale = self.models.vae_config.scaling_factor
            imgs = self.models.vae.decode(lat / scale).float() / 2 + 0.5
        imgs = imgs.clamp(0.0, 1.0).permute(0, 2, 3, 1)
        return quantise(imgs) if out_u8 else imgs

    def _decode_frames(self, lat: torch.Tensor, out_u8: bool) -> torch.Tensor:
        """The dispatch's decode: tiled under ``vae_tile`` (KL decoder
        only), else whole."""
        if self.vae_tile is not None and not self.tiny_decoder:
            imgs = self._decode_tiled(lat)
            return quantise(imgs.clamp(0.0, 1.0)) if out_u8 else imgs
        return self._decode(lat, out_u8)

    def _decode_tiled(self, lat: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> float32 (B, H, W, 3) frames,
        decoded in overlapping ``vae_tile`` latent tiles whose seams blend
        with linear ramps (``_tiled``)."""
        b, _, h, w = lat.shape
        if h <= self.vae_tile and w <= self.vae_tile:
            return self._decode(lat, out_u8=False)
        return self._tiled(lambda x: self._decode(x, out_u8=False), lat,
                           h, w, 1, self.models.vae_scale_factor, 3)

    def _tiled(self, fn, x: torch.Tensor, h: int, w: int, s_in: int,
               s_out: int, c_out: int) -> torch.Tensor:
        """``fn`` over overlapping ``vae_tile`` tiles of a (B, C, h·s_in,
        w·s_in) input, its (B, ·, ·, c_out) outputs blended at ``s_out``
        times the latent grid with linear ramps over the overlap, on the
        device.  Tiles sit on the latent grid (h, w); every tile is exactly
        ``vae_tile`` wide (the last position clamps back), so ``fn`` runs at
        one shape; an axis below one tile is taken whole."""
        tile, ov = self.vae_tile, self.vae_tile_overlap
        dev = x.device

        def ramp(n: int, lo_edge: bool, hi_edge: bool) -> torch.Tensor:
            r = torch.ones(n, device=dev)
            e = ov * s_out
            if e and lo_edge:
                r[:e] = torch.arange(e, device=dev) / e
            if e and hi_edge:
                r[-e:] = 1.0 - torch.arange(e, device=dev) / max(e - 1, 1)
            return r

        def positions(dim: int) -> list:
            if dim <= tile:
                return [0]
            pos = list(range(0, dim - tile + 1, tile - ov))
            if pos[-1] != dim - tile:
                pos.append(dim - tile)
            return pos

        ty, tx = min(tile, h), min(tile, w)
        out = torch.zeros(x.shape[0], h * s_out, w * s_out, c_out,
                          device=dev)
        weight = torch.zeros(1, h * s_out, w * s_out, 1, device=dev)
        for y0 in positions(h):
            for x0 in positions(w):
                y1, x1 = y0 + ty, x0 + tx
                part = fn(x[:, :, y0 * s_in:y1 * s_in, x0 * s_in:x1 * s_in])
                wmap = (ramp(ty * s_out, y0 > 0, y1 < h)[:, None]
                        * ramp(tx * s_out, x0 > 0, x1 < w)[None, :])[
                            None, :, :, None]
                oy, ox = slice(y0 * s_out, y1 * s_out), slice(x0 * s_out,
                                                              x1 * s_out)
                out[:, oy, ox] += part * wmap
                weight[:, oy, ox] += wmap
        return out / weight.clamp_min(1e-8)

    # ------------------------------------------------------------------
    # encode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_image(self, images) -> torch.Tensor:
        """(B, H, W, 3) images in [-1, 1] -> float32 (B, H/f, W/f, 4)
        scaled latents (the posterior mean times the scaling factor) on the
        device.  With ``vae_tile`` and an image larger than one tile, the
        encoder runs on overlapping tiles of ``vae_tile`` latents (the
        decode's grid), blended in latent space on the device."""
        img = self._to_device(images).float().permute(0, 3, 1, 2)
        f = self.models.vae_scale_factor
        h, w = img.shape[2] // f, img.shape[3] // f
        tile = self.vae_tile
        if tile is None or (h <= tile and w <= tile):
            return self._encode_whole(img)
        return self._tiled(self._encode_whole, img, h, w, f, 1,
                           self.models.vae_config.latent_channels)

    def _encode_whole(self, img: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] -> float32 (B, h, w, 4) scaled means."""
        mean, _ = self.models.vae.encode(img)
        return (mean.float() * self.models.vae_config.scaling_factor) \
            .permute(0, 2, 3, 1)

    def _added_conds(self, pad, pooled, uncond_pooled, B: int, Bp: int,
                     h: int, w: int) -> tuple:
        """SDXL text_time conditioning of one dispatch: the CFG-stacked
        pooled embeddings (uncond rows first, pad rows included) and the
        size/crop ids, (h·f, w·f, 0, 0, h·f, w·f) for every row, or the
        refiner's (h·f, w·f, 0, 0, score); () for the other families."""
        if not self.models.is_xl:
            if pooled is not None or uncond_pooled is not None:
                raise ValueError("pooled embeddings are SDXL conditioning; "
                                 "this bundle has no text_time")
            return ()
        if pooled is None:
            raise ValueError("SDXL bundle: pass pooled= (see "
                             "embed_text_pooled)")
        if uncond_pooled is None:
            uncond_pooled = self.embed_text_pooled("")
        pooled = self._to_device(pooled)
        uncond_pooled = self._to_device(uncond_pooled)
        if uncond_pooled.shape[0] == 1 and B > 1:
            uncond_pooled = uncond_pooled.expand(
                (B,) + tuple(uncond_pooled.shape[1:]))
        f = self.models.vae_scale_factor
        if self.models.unet_config.addition_num_ids == 5:
            # the refiner: (orig_h, orig_w, crop_t, crop_l, aesthetic
            # score), the score 2.5 on the uncond rows and 6.0 on the cond
            ids = torch.tensor([[h * f, w * f, 0, 0, a]
                                for a in REFINER_AESTHETIC],
                               dtype=torch.float32, device=self.device)
            ids = ids.repeat_interleave(Bp, dim=0)
        else:
            ids = torch.tensor([h * f, w * f, 0, 0, h * f, w * f],
                               dtype=torch.float32,
                               device=self.device).expand(2 * Bp, 6)
        return torch.cat([pad(uncond_pooled), pad(pooled)]), ids

    def _ctrl_args(self, pad, control, control_scale, B: int, h: int,
                   w: int) -> list:
        """ControlNet conditioning of one dispatch: [(NCHW float32 maps of
        Bp rows on the device, scale)], one pair a net.  ``control``: one
        map, (H, W, 3) or (B, H, W, 3) in [0, 1] at the output size, or a
        list of them matching the engine's nets; ``control_scale``: a float
        or one a net."""
        if control is None:
            return []
        if self.controlnet is None:
            raise ValueError("control= passed but this Engine has no "
                             "ControlNet (Engine(controlnet=...))")
        if self.step_cache:
            raise ValueError("control= cannot combine with step_cache (no "
                             "deep skips on the cached pass)")
        n = len(self.controlnet)
        maps = control if isinstance(control, (list, tuple)) else [control]
        if len(maps) != n:
            raise ValueError(f"this engine has {n} ControlNet(s) but got "
                             f"{len(maps)} control map(s)")
        scales = (list(control_scale)
                  if isinstance(control_scale, (list, tuple))
                  else [control_scale] * n)
        if len(scales) != n:
            raise ValueError(f"{len(scales)} control_scale values for "
                             f"{n} ControlNet(s)")
        f = self.models.vae_scale_factor
        out = []
        for cmap, scale in zip(maps, scales):
            c = self._to_device(cmap).float()
            if c.ndim == 3:
                c = c[None]
            if tuple(c.shape[1:]) != (h * f, w * f, 3):
                raise ValueError(
                    f"control map must be (B, {h * f}, {w * f}, 3) at this "
                    f"dispatch's resolution, got {tuple(c.shape)}")
            if c.shape[0] == 1 and B > 1:
                c = c.expand((B,) + tuple(c.shape[1:]))
            out.append((pad(c).permute(0, 3, 1, 2), float(scale)))
        return out

    def _ip_args(self, pad, ip_tokens, ip_scale, B: int):
        """IP-Adapter operands of one dispatch: (the CFG-stacked (2Bp, T,
        D) image tokens, the uncond half the projection of a zero
        embedding, scale), or None without an adapter.  With an adapter
        but no image the scale is 0, and the UNet's output is the
        adapter-free one."""
        if self.ip is None:
            if ip_tokens is not None:
                raise ValueError("ip_tokens= passed but this Engine has no "
                                 "IP-Adapter (Engine(ip_adapter=...))")
            return None
        un = self.ip.uncond_tokens()
        if ip_tokens is None:
            cond, ip_scale = un, 0.0
        else:
            cond = self._to_device(ip_tokens).float()
            if cond.ndim == 2:
                cond = cond[None]
        if cond.shape[0] == 1 and B > 1:
            cond = cond.expand((B,) + tuple(cond.shape[1:]))
        return (torch.cat([pad(un.expand(cond.shape)), pad(cond)]),
                float(ip_scale))

    def _residuals(self, ctrl: list, x, tb, ctx, xl: dict, cfg_on: bool,
                   guess_mode: bool) -> dict:
        """Each ControlNet's trunk on this step's inputs, the residuals
        summed over the nets; ``guess_mode`` zeroes the uncond half's in a
        CFG step.  -> the UNet's ``ctrl_down``/``ctrl_mid``."""
        down = mid = None
        for cn, (cmap, scale) in zip(self.controlnet, ctrl):
            d, m = cn.module(x, tb, ctx, cmap, conditioning_scale=scale,
                             **(xl if cn.config.addition_embed_dim
                                is not None else {}))
            if down is None:
                down, mid = list(d), m
            else:
                down = [a + b for a, b in zip(down, d)]
                mid = mid + m
        if guess_mode and cfg_on:
            half = x.shape[0] // 2
            keep = torch.cat([torch.zeros(half), torch.ones(
                x.shape[0] - half)]).to(device=mid.device, dtype=mid.dtype)[
                    :, None, None, None]
            down = [d * keep for d in down]
            mid = mid * keep
        return dict(ctrl_down=tuple(down), ctrl_mid=mid)

    @torch.no_grad()
    def _program(self, context, added, latents, guidance: float, sched,
                 tables, out_u8: bool, generator: NoiseSource,
                 after_step=None, ctrl=(), guess_mode: bool = False,
                 ip=None) -> torch.Tensor:
        """The denoise loop and the decode.  Each ``guidance_interval``
        segment runs with CFG (2B UNet rows, ``context``, the SDXL
        ``added`` conditions, the control maps doubled and the IP tokens
        whole) or cond-only (B rows, their cond halves).  With
        ``step_cache`` the full-trunk
        decision is a host boolean, and the deep feature a Python variable
        that each segment's first step (always full) sets.  A stochastic
        sampler's step gets a noise field drawn on the device.
        ``after_step(i, latents) -> latents`` runs after each step
        (inpaint's projection).  ``ctrl``: [(maps of B rows, scale)] a
        ControlNet (``_ctrl_args``); ``ip``: (tokens of 2B rows, scale)
        (``_ip_args``)."""
        unet, k = self.models.unet, self.step_cache
        split = self.step_cache_split if k else None
        lat = latents * sched.init_noise_sigma(tables)
        state = sched.init_state(tables, lat)
        n_loop = sched.num_loop_steps(tables)
        segments = self._interval_segments(n_loop)
        full_mask = (self._full_trunk_mask(segments, n_loop, k)
                     if k and self.step_cache_policy == "ends" else None)
        if not sched.draws_noise(tables):
            draw = None
        elif isinstance(generator, torch.Generator):
            def draw(i, x):
                return transition_noise(generator, x, self.frozen_noise)
        else:
            draw = generator
        def cond_half(t):
            return t[t.shape[0] // 2:]

        for a, b, cfg_on in segments:
            ctx = context if cfg_on else cond_half(context)
            add = added if cfg_on else tuple(map(cond_half, added))
            xl = dict(text_embeds=add[0], time_ids=add[1]) if add else {}
            maps = [(torch.cat([c, c]) if cfg_on else c, scale)
                    for c, scale in ctrl]
            ip_kw = ({} if ip is None else dict(
                ip_context=ip[0] if cfg_on else cond_half(ip[0]),
                ip_scale=ip[1]))
            deep = None
            for i in range(a, b):
                inp = sched.scale_model_input(tables, state, i, lat)
                x = torch.cat([inp, inp]) if cfg_on else inp
                tb = torch.full((x.shape[0],), sched.timestep(tables, i),
                                dtype=torch.float32, device=self.device)
                if k:
                    full = (full_mask[i] if full_mask is not None
                            else (i - a) % k == 0)
                    eps, deep = unet(x, tb, ctx, cache_split=split,
                                     deep_feature=None if full else deep,
                                     **xl, **ip_kw)
                else:
                    res = (self._residuals(maps, x, tb, ctx, xl, cfg_on,
                                           guess_mode) if maps else {})
                    eps = unet(x, tb, ctx, **xl, **res, **ip_kw)
                if cfg_on:
                    eps_u, eps_c = eps.chunk(2)
                    eps = apply_guidance(eps_u, eps_c, guidance,
                                         self.guidance_rescale)
                state, lat = sched.step(tables, state, i, eps, lat,
                                        draw(i, lat) if draw else None)
                if after_step is not None:
                    lat = after_step(i, lat)
        return self._decode_frames(lat, out_u8)

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)  # a flipped view has negative strides
        return torch.as_tensor(x).to(self.device)

    def _conditioning(self, cond, uncond, B: int, h: int, w: int, pooled,
                      uncond_pooled) -> tuple:
        """One dispatch of B rows at (h, w) latents: -> (pad, context,
        added), where ``pad`` fills a batch with zero rows up to the
        bucket, ``context`` is the CFG-stacked (uncond rows first)
        text context and ``added`` the SDXL conditions."""
        cond, uncond = self._to_device(cond), self._to_device(uncond)
        Bp = -(-B // self.batch_bucket) * self.batch_bucket
        if uncond.shape[0] == 1 and B > 1:
            uncond = uncond.expand((B,) + tuple(uncond.shape[1:]))

        def pad(x):
            if x.shape[0] == Bp:
                return x
            fill = x.new_zeros((Bp - x.shape[0],) + tuple(x.shape[1:]))
            return torch.cat([x, fill])

        context = torch.cat([pad(uncond), pad(cond)])
        added = self._added_conds(pad, pooled, uncond_pooled, B, Bp, h, w)
        return pad, context, added

    def _sampler(self, name: Optional[str] = None) -> tuple:
        """(name, sampler) of a dispatch: the named one, else the engine's,
        read once under the lock."""
        if name is not None:
            return name, get_scheduler(name)
        with self._lock:
            return self.scheduler_name, self.sched

    def _noise_source(self, generator) -> NoiseSource:
        return (generator if generator is not None else
                torch.Generator(device=self.device).manual_seed(0))

    def _field(self, noise, shape: tuple, generator) -> torch.Tensor:
        """An NCHW float32 noise field of ``shape`` on the device: the
        caller's NHWC ``noise`` (1 or ``shape[0]`` rows, broadcast), or a
        draw from ``generator``."""
        if noise is not None:
            return self._to_device(noise).float().permute(0, 3, 1, 2) \
                .expand(shape)
        if not isinstance(generator, torch.Generator):
            raise ValueError("a callable noise source replaces the step "
                             "draws only: pass the initial field as noise=")
        return torch.randn(shape, generator=generator, device=self.device,
                           dtype=torch.float32)

    @staticmethod
    def _check_output_dtype(output_dtype: str):
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be float32 or uint8, "
                             f"got {output_dtype!r}")

    def denoise_frames_async(self, cond, uncond, noise, *,
                             num_inference_steps: int = 50,
                             guidance_scale: float = 7.5, eta: float = 0.0,
                             generator: Optional[NoiseSource] = None,
                             output_dtype: str = "float32", pooled=None,
                             uncond_pooled=None, control=None,
                             control_scale=1.0, guess_mode: bool = False,
                             ip_tokens=None, ip_scale: float = 1.0,
                             scheduler: Optional[str] = None):
        """Enqueue one dispatch; returns (frames on the device, valid).

        cond/uncond: (B, S, D) text embeddings (uncond may be (1, S, D));
        noise: (B, h, w, 4).  An SDXL bundle also takes ``pooled`` (B, Dp)
        and ``uncond_pooled`` ((B or 1, Dp); by default the pooled
        embedding of ``""``), from ``embed_text_pooled``.  The batch is
        padded to the bucket, so callers slice ``[:valid]``.
        ``output_dtype="uint8"`` quantises on the device (after the blend,
        under ``vae_tile``).  ``eta`` is a ddim parameter.  ``generator`` is the stochastic samplers' noise source
        (the JAX engine's ``key``): a ``torch.Generator`` on the engine's
        device, by default one seeded 0, or a callable ``(i, latents) ->
        field`` (fields of the latents' shape, or ``(1, C, h, w)`` to
        broadcast over the batch) that replaces the draws.

        ``control``: the ControlNet map(s), (H, W, 3) or (B, H, W, 3) in [0,
        1] at the output size (a list for several nets; both CFG halves are
        conditioned), weighted by ``control_scale`` (a float or one a net);
        ``guess_mode`` steers the cond half only.  ``ip_tokens``: (1 or B,
        T, D) image tokens of the engine's IP-Adapter
        (``IPAdapter.image_tokens``), at ``ip_scale``.  ``scheduler``: the
        sampler of this dispatch by name (the engine's own is left as it
        is); by default the engine's."""
        self._check_output_dtype(output_dtype)
        noise = self._to_device(noise).float()
        B, h, w = noise.shape[:3]
        pad, context, added = self._conditioning(
            cond, uncond, B, h, w, pooled, uncond_pooled)
        ctrl = self._ctrl_args(pad, control, control_scale, B, h, w)
        ip = self._ip_args(pad, ip_tokens, ip_scale, B)
        latents = pad(noise).permute(0, 3, 1, 2)
        sched_name, sched = self._sampler(scheduler)
        imgs = self._program(context, added, latents, float(guidance_scale),
                             sched, self._tables(sched_name, sched,
                                                 num_inference_steps, eta),
                             output_dtype == "uint8",
                             self._noise_source(generator), ctrl=ctrl,
                             guess_mode=guess_mode, ip=ip)
        return imgs, B

    def img2img(self, cond, uncond, init_latents, *, strength: float = 0.75,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                eta: float = 0.0, generator: Optional[NoiseSource] = None,
                noise=None, output_dtype: str = "float32", pooled=None,
                uncond_pooled=None, control=None, control_scale=1.0,
                guess_mode: bool = False, ip_tokens=None,
                ip_scale: float = 1.0) -> np.ndarray:
        """Denoise from ``init_latents`` ((B, h, w, 4) scaled latents, as
        ``encode_image`` gives) noised to the schedule's entry point:
        ``strength`` in (0, 1] is the share of the schedule that runs (1:
        txt2img from noise).  The sigma samplers noise as x + σ₀·noise, the
        others by ``add_noise`` at the first timestep that runs.  ``noise``:
        one (1 or B, h, w, 4) field, broadcast over the batch (vid2vid's
        shared field); otherwise it is drawn from ``generator``, which then
        also gives the stochastic samplers' step fields.  The ControlNet
        and IP-Adapter arguments are ``denoise_frames_async``'s.  -> numpy
        (B, H, W, 3) frames, float32 in [0, 1] or uint8."""
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        self._check_output_dtype(output_dtype)
        lat = self._to_device(init_latents).float().permute(0, 3, 1, 2)
        B, _, h, w = lat.shape
        sched_name, sched = self._sampler()
        tables, run, _ = self._entry_tables(
            sched_name, sched, num_inference_steps, eta, strength)
        generator = self._noise_source(generator)
        noise = self._field(noise, tuple(lat.shape), generator)
        if sched_name in SIGMA_SAMPLERS:
            noisy = lat + float(run["sigmas"][0]) * noise
        else:
            noisy = sched.add_noise(tables, lat, noise,
                                    int(run["timesteps"][0]))
        pad, context, added = self._conditioning(
            cond, uncond, B, h, w, pooled, uncond_pooled)
        imgs = self._program(
            context, added, pad(noisy), float(guidance_scale), sched, run,
            output_dtype == "uint8", generator,
            ctrl=self._ctrl_args(pad, control, control_scale, B, h, w),
            guess_mode=guess_mode,
            ip=self._ip_args(pad, ip_tokens, ip_scale, B))
        return imgs[:B].cpu().numpy()

    def inpaint(self, cond, uncond, init_latents, mask, *,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                eta: float = 0.0, generator: Optional[NoiseSource] = None,
                noise=None, output_dtype: str = "float32", pooled=None,
                uncond_pooled=None, ip_tokens=None,
                ip_scale: float = 1.0) -> np.ndarray:
        """Regenerate where ``mask`` is 1 and keep ``init_latents`` where it
        is 0: the whole schedule runs from noise, and after every step the
        known region is put back at that step's post-step noise level
        (``sigmas[i+1]`` for the sigma samplers; ``alphas_cumprod`` at the
        next timestep for the others, and the clean latents after the last
        step).  init_latents: (B, h, w, 4) scaled latents; mask: (B, h, w,
        1) in [0, 1] at latent size.  One field ``noise0`` ((1 or B, h, w,
        4), else drawn from ``generator``) is both the first latents and
        every injection's noise.  The KL decode is tiled under
        ``vae_tile``; the engine's step caching and guidance interval apply
        as in a txt2img dispatch (the JAX engine's inpaint program runs
        neither).  ``ip_tokens``/``ip_scale`` as ``denoise_frames_async``.
        -> numpy (B, H, W, 3) frames."""
        self._check_output_dtype(output_dtype)
        init = self._to_device(init_latents).float().permute(0, 3, 1, 2)
        B, _, h, w = init.shape
        pad, context, added = self._conditioning(
            cond, uncond, B, h, w, pooled, uncond_pooled)
        sched_name, sched = self._sampler()
        tables = self._tables(sched_name, sched, num_inference_steps, eta)
        generator = self._noise_source(generator)
        init = pad(init)
        noise0 = pad(self._field(noise, tuple(init[:B].shape), generator))
        m = pad(self._to_device(mask).float().permute(0, 3, 1, 2)
                .expand(B, 1, h, w))
        n_loop = sched.num_loop_steps(tables)
        sigma_space = sched_name in SIGMA_SAMPLERS

        def known(i):
            """The known region at loop index i's post-step noise level
            (euler_ancestral's is sigmas[i+1] too: its sigma_down and
            sigma_up recombine to it)."""
            if sigma_space:
                return init + float(tables["sigmas"][i + 1]) * noise0
            if i >= n_loop - 1:
                return init
            return sched.add_noise(tables, init, noise0,
                                   int(tables["timesteps"][i + 1]))

        imgs = self._program(context, added, noise0, float(guidance_scale),
                             sched, tables, output_dtype == "uint8",
                             generator, after_step=lambda i, lat: (
                                 m * lat + (1.0 - m) * known(i)),
                             ip=self._ip_args(pad, ip_tokens, ip_scale, B))
        return imgs[:B].cpu().numpy()

    def denoise_frames_device(self, cond, uncond, noise,
                              **kw) -> torch.Tensor:
        """``denoise_frames_async``'s frames cut to the batch, on the
        device.  When the card runs out of memory (``is_out_of_memory``)
        the cached blocks are freed, the batch is split in half, every
        batch-aligned argument with it (``batch_part``: cond, uncond, the
        pooled embeddings, per-frame control maps, image tokens), and each
        half runs the same way; the halves' frames are concatenated.  A
        deterministic sampler's frames do not depend on the split."""
        B = int(noise.shape[0])
        try:
            imgs, valid = self.denoise_frames_async(cond, uncond, noise, **kw)
            return imgs[:valid]
        except RuntimeError as e:
            if not is_out_of_memory(e) or B <= 1:
                raise
            logger.warning("out of device memory at batch %d (%s); retrying "
                           "as %d + %d", B, type(e).__name__, B // 2,
                           B - B // 2)
        # outside the handler: the failed dispatch's tensors are released
        # with its traceback before the halves allocate
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        half = B // 2
        parts = []
        for sl in (slice(None, half), slice(half, None)):
            parts.append(self.denoise_frames_device(
                batch_part(cond, B, sl), batch_part(uncond, B, sl),
                batch_part(noise, B, sl),
                **{k: batch_part(v, B, sl) for k, v in kw.items()}))
        return torch.cat(parts)

    def denoise_frames(self, cond, uncond, noise, **kw) -> np.ndarray:
        """Blocking variant -> numpy (B, H, W, 3), float32 in [0, 1] (or
        uint8 with ``output_dtype="uint8"``), split on out-of-memory as
        ``denoise_frames_device``."""
        return self.denoise_frames_device(cond, uncond, noise,
                                          **kw).cpu().numpy()

    def warmup(self, *, num_inference_steps: int = 50,
               height: Optional[int] = None, width: Optional[int] = None,
               batches=(None,), output_dtype: str = "float32",
               scheduler: Optional[str] = None) -> float:
        """Run one dispatch a batch of ``batches`` (None: the bucket) at
        zero inputs, so that the kernel library is built, loaded and its
        kernels prepared, cuDNN has chosen its plans and the sampler's
        tables are cached before the first request.  ``scheduler``: the sampler
        to warm, by name (the engine's own is left as it is; by default
        it).  Each (sampler, batch, latent size, steps, output dtype) is
        added to ``warmed``.  -> the seconds it took, the device
        synchronized."""
        self._check_output_dtype(output_dtype)
        sched_name = scheduler or self._sampler()[0]
        height = height or self.models.default_size
        width = width or self.models.default_size
        f = self.models.vae_scale_factor
        c = self.models.unet_config.in_channels
        d = self.models.unet_config.cross_attention_dim
        h, w = height // f, width // f
        t0 = time.perf_counter()
        for b in batches:
            b = b or self.batch_bucket
            cond = torch.zeros(b, 77, d, device=self.device)
            kw = {}
            if self.models.is_xl:
                dp = self.models.unet_config.addition_pooled_dim
                kw = dict(pooled=torch.zeros(b, dp, device=self.device),
                          uncond_pooled=torch.zeros(1, dp,
                                                    device=self.device))
            self.denoise_frames_device(
                cond, cond[:1], torch.zeros(b, h, w, c, device=self.device),
                num_inference_steps=num_inference_steps,
                output_dtype=output_dtype, scheduler=sched_name,
                **kw).cpu()
            with self._lock:
                self.warmed.add((sched_name, b, h, w,
                                 int(num_inference_steps), output_dtype))
        return time.perf_counter() - t0

    @torch.no_grad()
    def check_safety(self, images) -> torch.Tensor:
        """(B, H, W, 3) frames in [0, 1] (array or tensor) -> (B,) bool
        flags on the device, from the bundle's safety checker (all False
        when it has none); the caller blacks the flagged frames out.
        Nothing here waits for the device."""
        images = self._to_device(images)
        checker = self.models.safety_checker()
        if checker is None:
            return torch.zeros(images.shape[0], dtype=torch.bool,
                               device=self.device)
        return checker(preprocess_for_safety(
            images, checker.config.vision.image_size))

    @torch.no_grad()
    def decode_latents(self, latents) -> np.ndarray:
        """(B, h, w, 4) scaled latents -> float32 (B, H, W, 3) in [0, 1]:
        whole, or in tiles when ``vae_tile`` is set."""
        lat = self._to_device(latents).float().permute(0, 3, 1, 2)
        return self._decode_frames(lat, out_u8=False).cpu().numpy()

    @torch.no_grad()
    def decode_latents_tiled(self, latents) -> np.ndarray:
        """(B, h, w, 4) scaled latents -> float32 (B, 8h, 8w, 3) frames,
        decoded by the KL decoder in overlapping ``vae_tile`` tiles."""
        if self.vae_tile is None:
            raise ValueError("decode_latents_tiled needs Engine(vae_tile=...)")
        lat = self._to_device(latents).float().permute(0, 3, 1, 2)
        return self._decode_tiled(lat).cpu().numpy()


def quantise(imgs: torch.Tensor) -> torch.Tensor:
    """[0, 1] float frames -> uint8, rounded, on their device."""
    return torch.round(imgs * 255.0).to(torch.uint8)
