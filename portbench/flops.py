"""The work of the cells' computations, counted from the configuration's
shapes, whatever kernels compute it: the operations of every convolution,
linear layer and attention product (2 a multiply-add, as
``torch.utils.flop_counter`` counts them), and each attention and
GroupNorm(+SiLU) call with its shape, for the rooflines.

The bound of a call is max(operations / peak FLOP/s, bytes / peak bytes/s)
with each input read once and each output written once (the arithmetic of
``chip_smoke.py`` phase 3, copied here).  Peaks: one NVIDIA H100 SXM, dense
bf16 989 TFLOP/s, HBM3 3.35 TB/s.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .reference.models import unet_levels

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
CONTEXT = 77


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    #: (B, H, Sq, Sk, D) of each attention call
    attention: List[Tuple[int, int, int, int, int]] = \
        dataclasses.field(default_factory=list)
    #: (N, C, H, W) of each GroupNorm(+SiLU) call
    groupnorm: List[Tuple[int, int, int, int]] = \
        dataclasses.field(default_factory=list)

    def __iadd__(self, other: "Work") -> "Work":
        self.flops += other.flops
        self.attention += other.attention
        self.groupnorm += other.groupnorm
        return self

    def times(self, n: int) -> "Work":
        return Work(self.flops * n, self.attention * n, self.groupnorm * n)


def attention_flops(b, h, sq, sk, d) -> float:
    return 4.0 * b * h * sq * sk * d


def attention_bytes(b, h, sq, sk, d, itemsize: int = 2) -> float:
    """q and o of Sq rows, k and v of Sk rows, each moved once."""
    return float(itemsize * b * h * d * (2 * sq + 2 * sk))


def groupnorm_bytes(n, c, h, w, itemsize: int = 2) -> float:
    """The input read once and the output written once (weight and bias
    too)."""
    return float(itemsize * (2 * n * c * h * w + 2 * c))


def bound_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def attention_bound(calls) -> float:
    return sum(bound_seconds(attention_flops(*c), attention_bytes(*c))
               for c in calls)


def groupnorm_bound(calls) -> float:
    return sum(bound_seconds(8.0 * c[0] * c[1] * c[2] * c[3],
                             groupnorm_bytes(*c)) for c in calls)


class _Counter:
    def __init__(self):
        self.w = Work()

    def conv(self, n, cin, cout, k, h_out, w_out):
        self.w.flops += 2.0 * n * cin * cout * k * k * h_out * w_out

    def linear(self, tokens, fin, fout):
        self.w.flops += 2.0 * tokens * fin * fout

    def attn(self, b, heads, sq, sk, d):
        self.w.flops += attention_flops(b, heads, sq, sk, d)
        self.w.attention.append((b, heads, sq, sk, d))

    def gn(self, n, c, h, w):
        self.w.groupnorm.append((n, c, h, w))

    def resnet(self, n, cin, cout, h, w, temb):
        self.gn(n, cin, h, w)
        self.conv(n, cin, cout, 3, h, w)
        if temb:
            self.linear(n, temb, cout)
        self.gn(n, cout, h, w)
        self.conv(n, cout, cout, 3, h, w)
        if cin != cout:
            self.conv(n, cin, cout, 1, h, w)


def unet(cfg: dict, rows: int, h: int, w: int) -> Work:
    """One UNet call on ``rows`` latents of (h, w)."""
    k = _Counter()
    levels = unet_levels(cfg)
    n_lv = len(levels)
    c0 = levels[0][0]
    temb = 4 * c0
    ctx = cfg["cross_attention_dim"]
    lpb = cfg["layers_per_block"]
    k.linear(rows, c0, temb)
    k.linear(rows, temb, temb)
    if cfg.get("addition_embed_type") == "text_time":
        k.linear(rows, cfg["projection_class_embeddings_input_dim"], temb)
        k.linear(rows, temb, temb)

    def transformer(ch, heads, depth, hh, ww):
        s = hh * ww
        k.gn(rows, ch, hh, ww)
        k.linear(rows * s, ch, ch)  # proj_in (1x1 convolution or Linear)
        for _ in range(depth):
            k.linear(rows * s, ch, ch * 3)
            k.attn(rows, heads, s, s, ch // heads)
            k.linear(rows * s, ch, ch)
            k.linear(rows * s, ch, ch)
            k.linear(rows * CONTEXT, ctx, ch * 2)
            k.attn(rows, heads, s, CONTEXT, ch // heads)
            k.linear(rows * s, ch, ch)
            k.linear(rows * s, ch, 8 * ch)
            k.linear(rows * s, 4 * ch, ch)
        k.linear(rows * s, ch, ch)  # proj_out

    k.conv(rows, cfg["in_channels"], c0, 3, h, w)
    skips = [c0]
    ch, hh, ww = c0, h, w
    for i, (cout, heads, depth) in enumerate(levels):
        for _ in range(lpb):
            k.resnet(rows, ch, cout, hh, ww, temb)
            ch = cout
            if depth:
                transformer(ch, heads, depth, hh, ww)
            skips.append(ch)
        if i < n_lv - 1:
            hh, ww = hh // 2, ww // 2
            k.conv(rows, ch, ch, 3, hh, ww)
            skips.append(ch)
    mid = cfg.get("transformer_layers_per_block", 1)
    mid = mid if isinstance(mid, int) else mid[-1]
    k.resnet(rows, ch, ch, hh, ww, temb)
    transformer(ch, levels[-1][1], mid, hh, ww)
    k.resnet(rows, ch, ch, hh, ww, temb)
    for i in range(n_lv):
        cout, heads, depth = levels[n_lv - 1 - i]
        for _ in range(lpb + 1):
            k.resnet(rows, ch + skips.pop(), cout, hh, ww, temb)
            ch = cout
            if depth:
                transformer(ch, heads, depth, hh, ww)
        if i < n_lv - 1:
            hh, ww = hh * 2, ww * 2
            k.conv(rows, ch, ch, 3, hh, ww)
    k.gn(rows, c0, h, w)
    k.conv(rows, c0, cfg["out_channels"], 3, h, w)
    return k.w


def vae_decode(cfg: dict, rows: int, h: int, w: int) -> Work:
    """The KL decoder (with post_quant_conv) on ``rows`` latents of
    (h, w)."""
    k = _Counter()
    chans, lat, lpb = (cfg["block_out_channels"], cfg["latent_channels"],
                       cfg["layers_per_block"])
    k.conv(rows, lat, lat, 1, h, w)
    ch = chans[-1]
    k.conv(rows, lat, ch, 3, h, w)
    k.resnet(rows, ch, ch, h, w, None)
    k.gn(rows, ch, h, w)
    k.linear(rows * h * w, ch, 4 * ch)
    k.attn(rows, 1, h * w, h * w, ch)
    k.resnet(rows, ch, ch, h, w, None)
    hh, ww = h, w
    for i, cout in enumerate(reversed(chans)):
        for _ in range(lpb + 1):
            k.resnet(rows, ch, cout, hh, ww, None)
            ch = cout
        if i < len(chans) - 1:
            hh, ww = hh * 2, ww * 2
            k.conv(rows, ch, ch, 3, hh, ww)
    k.gn(rows, ch, hh, ww)
    k.conv(rows, ch, cfg["out_channels"], 3, hh, ww)
    return k.w


def text_tower(cfg: dict, rows: int, projection: bool = False) -> Work:
    """One text tower on ``rows`` prompts of 77 tokens."""
    k = _Counter()
    d, inner, heads = (cfg["hidden_size"], cfg["intermediate_size"],
                       cfg["num_attention_heads"])
    t = rows * CONTEXT
    for _ in range(cfg["num_hidden_layers"]):
        k.linear(t, d, 4 * d)
        k.w.flops += attention_flops(rows, heads, CONTEXT, CONTEXT,
                                     d // heads)
        k.linear(t, d, 2 * inner)
    if projection:
        k.linear(rows, d, cfg["projection_dim"])
    return k.w


def text(config: dict, rows: int) -> Work:
    """Every text tower of the configuration on ``rows`` prompts."""
    w = text_tower(config["text_encoder"], rows)
    if config.get("text_encoder_2"):
        w += text_tower(config["text_encoder_2"], rows, projection=True)
    return w


def dispatch(config: dict, rows: int, unet_calls: int, cfg_on: bool,
             latent: tuple) -> Work:
    """One denoise dispatch of ``rows`` frames: every UNet call at its CFG
    rows, then the decode.  The text towers are counted apart, once a
    prompt encoded (``text``)."""
    h, w = latent
    work = unet(config["unet"], rows * (2 if cfg_on else 1), h, w) \
        .times(unet_calls)
    work += vae_decode(config["vae"], rows, h, w)
    return work
