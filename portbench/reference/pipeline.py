"""The plain reference of what the benchmark's cells produce: prompt ->
token ids -> text states, the walk's trajectories (lerp of the embeddings,
slerp of the seeded noise), the CFG denoise loop under pndm (PLMS), euler
or lcm, the KL decode and the uint8 quantisation.

Float32 throughout, TF32 off (``float32_mode``).  Written from the
published samplers (diffusers ``PNDMScheduler`` with ``skip_prk_steps``,
``EulerDiscreteScheduler``, ``LCMScheduler``) with the JAX package's
choices where they differ from today's diffusers, so that it states what
the port claims to compute: euler starts at the largest sigma (diffusers
now takes sqrt(sigma² + 1) under "leading" spacing), and the tokenizer is
the repository's word-hash stub, since no vocabulary ships with it.
Imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import re

import numpy as np
import torch

# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def float32_mode():
    """Matmuls and convolutions in full float32 (TF32 off) for the block;
    the previous settings come back after it."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ---------------------------------------------------------------------------
# tokenizer: the repository's word-hash stub
# ---------------------------------------------------------------------------

def token_ids(text: str, vocab_size: int, pad_id=None,
              length: int = 77) -> list:
    """BOS (vocab - 2), each whitespace-separated lower-cased word's SHA-1
    modulo (vocab - 2), EOS (vocab - 1), then padding (EOS, or ``pad_id``);
    cut to ``length`` keeping the EOS last."""
    bos, eos = vocab_size - 2, vocab_size - 1
    words = re.sub(r"\s+", " ", text).strip().lower().split(" ")
    ids = [bos] + [int(hashlib.sha1(w.encode()).hexdigest(), 16)
                   % (vocab_size - 2) for w in words if w] + [eos]
    if len(ids) > length:
        ids = ids[:length - 1] + [eos]
    pad = eos if pad_id is None else pad_id
    return ids + [pad] * (length - len(ids))


def encode_prompts(mods: dict, config: dict, prompts: list,
                   device) -> tuple:
    """Prompts -> (context (N, 77, D), pooled (N, Dp) or None): tower 1
    alone, or for SDXL both towers' states concatenated and tower 2's
    projected pooled output."""
    te = config["text_encoder"]
    ids = torch.tensor([token_ids(p, te["vocab_size"]) for p in prompts],
                       device=device)
    h1, _ = mods["text_encoder"](ids)
    te2 = config.get("text_encoder_2")
    if not te2:
        return h1, None
    pad2 = config.get("pipeline", {}).get("pad_token_id_2")
    ids2 = torch.tensor([token_ids(p, te2["vocab_size"], pad2)
                         for p in prompts], device=device)
    h2, pooled = mods["text_encoder_2"](ids2)
    return torch.cat([h1, h2], -1), pooled


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

def noise_for_seed(seed: int, shape: tuple) -> torch.Tensor:
    """The initial latent noise of a seed: torch's CPU generator, NCHW."""
    g = torch.Generator("cpu").manual_seed(int(seed))
    return torch.randn(shape, generator=g, dtype=torch.float32)


def lerp(t: float, a, b):
    return (1.0 - t) * a + t * b


def slerp(t: float, a, b, threshold: float = 0.9995):
    """Spherical interpolation of the tensors as flat vectors; linear where
    they are nearly parallel."""
    dot = (a * b).sum() / (a.norm() * b.norm())
    if dot.abs() > threshold:
        return lerp(t, a, b)
    theta = torch.arccos(dot.clamp(-1.0, 1.0))
    s = torch.sin(theta)
    return (torch.sin(theta * (1 - t)) / s) * a + (torch.sin(theta * t) / s) * b


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def alphas_cumprod(sched: dict) -> np.ndarray:
    n = sched["num_train_timesteps"]
    b0, b1 = sched["beta_start"], sched["beta_end"]
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError(sched["beta_schedule"])
    betas = np.linspace(b0 ** 0.5, b1 ** 0.5, n, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def leading_timesteps(sched: dict, steps: int) -> np.ndarray:
    ratio = sched["num_train_timesteps"] // steps
    return (np.arange(steps) * ratio)[::-1] + sched["steps_offset"]


class PNDM:
    """PLMS as diffusers' ``step_plms``: the first step is taken twice (the
    second time from the stored sample with the mean of two outputs), then
    Adams-Bashforth of order 2, 3 and 4 over the stored outputs."""

    def __init__(self, sched: dict, steps: int):
        self.acp = alphas_cumprod(sched)
        self.final = 1.0 if sched["set_alpha_to_one"] else self.acp[0]
        self.ratio = sched["num_train_timesteps"] // steps
        ts = np.arange(steps) * self.ratio + sched["steps_offset"]
        self.timesteps = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
        self.init_sigma = 1.0
        self.ets, self.counter, self.cur = [], 0, None

    def scale(self, x, i):
        return x

    def step(self, eps, i, x, noise=None):
        t = int(self.timesteps[i])
        prev = t - self.ratio
        if self.counter != 1:
            self.ets = (self.ets + [eps])[-4:]
        else:
            prev, t = t, t + self.ratio
        e = self.ets
        if len(e) == 1 and self.counter == 0:
            out, self.cur = eps, x
        elif len(e) == 1 and self.counter == 1:
            out, x, self.cur = (eps + e[-1]) / 2, self.cur, None
        elif len(e) == 2:
            out = (3 * e[-1] - e[-2]) / 2
        elif len(e) == 3:
            out = (23 * e[-1] - 16 * e[-2] + 5 * e[-3]) / 12
        else:
            out = (55 * e[-1] - 59 * e[-2] + 37 * e[-3] - 9 * e[-4]) / 24
        self.counter += 1
        a = self.acp[t]
        a_prev = self.acp[prev] if prev >= 0 else self.final
        b, b_prev = 1 - a, 1 - a_prev
        coeff = (a_prev / a) ** 0.5
        denom = a * b_prev ** 0.5 + (a * b * a_prev) ** 0.5
        return float(coeff) * x - float((a_prev - a) / denom) * out


class Euler:
    """Euler over the training sigmas at the leading timesteps; the UNet
    sees x / sqrt(sigma² + 1); the latents start at the largest sigma."""

    def __init__(self, sched: dict, steps: int):
        acp = alphas_cumprod(sched)
        train = ((1 - acp) / acp) ** 0.5
        self.timesteps = leading_timesteps(sched, steps).astype(np.float64)
        sig = np.interp(self.timesteps, np.arange(len(train)), train)
        self.sigmas = np.concatenate([sig, [0.0]])
        self.init_sigma = float(self.sigmas.max())

    def scale(self, x, i):
        return x / float((self.sigmas[i] ** 2 + 1) ** 0.5)

    def step(self, eps, i, x, noise=None):
        return x + eps * float(self.sigmas[i + 1] - self.sigmas[i])


class LCM:
    """Latent-consistency sampling: the boundary-condition blend of the
    sample and its x0 estimate, re-noised to the next timestep with the
    step's field, except after the last step."""

    sigma_data, timestep_scaling = 0.5, 10.0

    def __init__(self, sched: dict, steps: int, original: int = 50):
        self.acp = alphas_cumprod(sched)
        k = sched["num_train_timesteps"] // original
        origin = (np.arange(1, original + 1) * k - 1)[::-1]
        self.timesteps = origin[::len(origin) // steps][:steps]
        self.init_sigma = 1.0

    def scale(self, x, i):
        return x

    def step(self, eps, i, x, noise=None):
        t = int(self.timesteps[i])
        a = self.acp[t]
        x0 = (x - float((1 - a) ** 0.5) * eps) / float(a ** 0.5)
        st = self.timestep_scaling * t
        sd2 = self.sigma_data ** 2
        c_skip, c_out = sd2 / (st ** 2 + sd2), st / (st ** 2 + sd2) ** 0.5
        den = float(c_out) * x0 + float(c_skip) * x
        if i == len(self.timesteps) - 1:
            return den
        a_next = self.acp[int(self.timesteps[i + 1])]
        return float(a_next ** 0.5) * den + float((1 - a_next) ** 0.5) * noise


SAMPLERS = {"pndm": PNDM, "euler": Euler, "lcm": LCM}


def unet_calls(sampler: str, sched: dict, steps: int) -> int:
    """UNet calls of one denoise loop."""
    return len(SAMPLERS[sampler](sched, steps).timesteps)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def denoise(mods: dict, config: dict, spec: dict, cond, uncond, pooled,
            uncond_pooled, noise, fields=None):
    """One batch of frames: ``cond`` (N, 77, D) and ``noise`` (N, 4, h, w)
    -> uint8 (N, H, W, 3).  ``spec``: sampler, steps, guidance, cfg (False:
    the cond branch alone).  ``fields``: the stochastic sampler's
    transition noise, one (1 or N, 4, h, w) field a step."""
    unet, vae = mods["unet"], mods["vae"]
    sampler = SAMPLERS[spec["sampler"]](config["scheduler"], spec["steps"])
    n = noise.shape[0]
    cfg_on = spec.get("cfg", True)
    x = noise * sampler.init_sigma
    ctx = torch.cat([uncond.expand_as(cond), cond]) if cfg_on else cond
    xl = {}
    if pooled is not None:
        f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
        h, w = noise.shape[-2] * f, noise.shape[-1] * f
        ids = torch.tensor([h, w, 0, 0, h, w], dtype=torch.float32,
                           device=noise.device)
        emb = torch.cat([uncond_pooled.expand_as(pooled), pooled]) \
            if cfg_on else pooled
        xl = dict(text_embeds=emb, time_ids=ids.expand(emb.shape[0], 6))
    for i, t in enumerate(sampler.timesteps):
        inp = sampler.scale(x, i)
        inp = torch.cat([inp, inp]) if cfg_on else inp
        tt = torch.full((inp.shape[0],), float(t), device=noise.device)
        eps = unet(inp, tt, ctx, **xl)
        if cfg_on:
            eu, ec = eps.chunk(2)
            eps = eu + spec["guidance"] * (ec - eu)
        x = sampler.step(eps, i, x, None if fields is None else fields[i])
    out = []
    for j in range(n):  # one frame at a time: the decoder's activations
        img = vae.decode(x[j:j + 1]) / 2 + 0.5
        out.append(quantise(img.clamp(0, 1).permute(0, 2, 3, 1)))
    return torch.cat(out)


def quantise(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8, rounded half to even."""
    return torch.round(img * 255.0).to(torch.uint8)
