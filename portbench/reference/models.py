"""Plain float32 PyTorch networks of Stable Diffusion, frozen beside the
benchmark: the CLIP text towers, the conditional UNet (SD 1.x and SDXL-base
with its text_time conditioning) and the KL autoencoder.

Written from the published diffusers/transformers definitions and the
configuration files under ``portbench/configs``; nothing here imports the
port or JAX.  Parameter names are the diffusers names, so one state dict
fills these modules and the port's.  Attention is a plain product and
softmax.  ``QUANT`` is the control's hook: when set, every linear layer's
and convolution's weight and input pass through it (the fp8 control,
``fp8_fake``); left at None the modules are plain float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

#: the control's quantiser of weights and inputs, or None (plain fp32)
QUANT = None


def fp8_fake(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (its absolute
    maximum onto 448, the format's largest), returned in float32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def _q(x):
    return x if QUANT is None else QUANT(x)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(_q(x), _q(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(_q(x), _q(self.weight), self.bias)


def attention(q, k, v, heads: int, causal: bool = False):
    """(B, Sq, H·D), (B, Sk, H·D) -> (B, Sq, H·D): softmax(q kᵀ / √D) v."""
    b, sq, c = q.shape
    d = c // heads
    q = q.view(b, sq, heads, d).transpose(1, 2)
    k = k.view(b, -1, heads, d).transpose(1, 2)
    v = v.view(b, -1, heads, d).transpose(1, 2)
    s = torch.matmul(_q(q), _q(k).transpose(-1, -2)) * d ** -0.5
    if causal:
        keep = torch.ones(sq, sq, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    out = torch.matmul(_q(s.softmax(-1)), _q(v))
    return out.transpose(1, 2).reshape(b, sq, c)


# ---------------------------------------------------------------------------
# CLIP text tower (transformers CLIPTextModel / CLIPTextModelWithProjection)
# ---------------------------------------------------------------------------

class CLIPAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)

    def forward(self, x):
        return self.out_proj(attention(self.q_proj(x), self.k_proj(x),
                                       self.v_proj(x), self.heads, True))


class CLIPMLP(nn.Module):
    def __init__(self, d, inner, act):
        super().__init__()
        self.act = act
        self.fc1, self.fc2 = Linear(d, inner), Linear(inner, d)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" \
            else F.gelu(h)
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = CLIPAttention(d, cfg["num_attention_heads"])
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(d, cfg["intermediate_size"], cfg["hidden_act"])

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg["vocab_size"],
                                            cfg["hidden_size"])
        self.position_embedding = nn.Embedding(
            cfg["max_position_embeddings"], cfg["hidden_size"])


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPLayer(cfg) for _ in range(cfg["num_hidden_layers"]))


class _TextModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"],
                                             eps=cfg["layer_norm_eps"])


class CLIPText(nn.Module):
    """``forward(ids) -> (hidden states, pooled)``: the last layer's states
    after the final LayerNorm, or with ``penultimate`` the states after the
    second-to-last layer (``hidden_states[-2]``); the pooled output is the
    final-LN state at the EOS token (the highest id), through
    ``text_projection`` when the tower has one."""

    def __init__(self, cfg, penultimate: bool = False,
                 projection: bool = False):
        super().__init__()
        self.penultimate = penultimate
        self.text_model = _TextModel(cfg)
        if projection:
            self.text_projection = Linear(cfg["hidden_size"],
                                          cfg["projection_dim"], bias=False)

    def forward(self, ids):
        tm = self.text_model
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = tm.embeddings.token_embedding(ids) \
            + tm.embeddings.position_embedding(pos)[None]
        states = [x]
        for layer in tm.encoder.layers:
            x = layer(x)
            states.append(x)
        last = tm.final_layer_norm(x)
        pooled = last[torch.arange(ids.shape[0]), ids.argmax(-1)]
        if hasattr(self, "text_projection"):
            pooled = self.text_projection(pooled)
        return (states[-2] if self.penultimate else last), pooled


# ---------------------------------------------------------------------------
# UNet2DConditionModel
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                       shift: float) -> torch.Tensor:
    """diffusers ``get_timestep_embedding``: (N,) -> (N, dim)."""
    half = dim // 2
    exponent = -math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    emb = torch.cat([emb.sin(), emb.cos()], -1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], -1)
    return emb


class TimestepMLP(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(cin, cout), Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, eps, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        if temb:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx_dim, dim, bias=False)
        self.to_v = Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        return self.to_out[0](attention(self.to_q(x), self.to_k(ctx),
                                        self.to_v(ctx), self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, -1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class TransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, ctx_dim, heads)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm (eps 1e-6), proj_in (a 1x1 convolution, or a Linear over
    channels under ``use_linear_projection``), the blocks, proj_out, plus
    the input."""

    def __init__(self, ch, ctx_dim, heads, depth, linear, groups):
        super().__init__()
        self.linear = linear
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        proj = (lambda: Linear(ch, ch)) if linear else \
            (lambda: Conv2d(ch, ch, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(ch, ctx_dim, heads) for _ in range(depth))
        self.proj_out = proj()

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.norm(x)
        if not self.linear:
            y = self.proj_in(y)
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.linear:
            y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        if self.linear:
            y = self.proj_out(y)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.linear:
            y = self.proj_out(y)
        return y + x


class _Conv(nn.Module):
    """``downsamplers.0`` / ``upsamplers.0``: a 3x3 convolution, stride 2
    (padding 1) down, after a nearest 2x upsample up."""

    def __init__(self, ch, down):
        super().__init__()
        self.down = down
        self.conv = Conv2d(ch, ch, 3, stride=2 if down else 1,
                           padding=1)

    def forward(self, x):
        if not self.down:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x)


class _AsymmetricDown(nn.Module):
    """The VAE encoder's downsample: pad (0, 1), 3x3 stride 2."""

    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Block(nn.Module):
    def __init__(self, resnets, attentions=(), down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])


def unet_levels(cfg: dict) -> list:
    """Per level: (channels, heads, transformer depth or 0)."""
    chans = cfg["block_out_channels"]
    heads = cfg["attention_head_dim"]
    depth = cfg.get("transformer_layers_per_block", 1)
    out = []
    for i, (ch, kind) in enumerate(zip(chans, cfg["down_block_types"])):
        h = heads if isinstance(heads, int) else heads[i]
        d = depth if isinstance(depth, int) else depth[i]
        out.append((ch, h, d if kind.startswith("CrossAttn") else 0))
    return out


class UNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        levels = unet_levels(cfg)
        n = len(levels)
        groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        ctx = cfg["cross_attention_dim"]
        linear = cfg.get("use_linear_projection", False)
        lpb = cfg["layers_per_block"]
        c0 = levels[0][0]
        temb = 4 * c0
        self.conv_in = Conv2d(cfg["in_channels"], c0, 3, padding=1)
        self.time_embedding = TimestepMLP(c0, temb)
        if cfg.get("addition_embed_type") == "text_time":
            self.add_embedding = TimestepMLP(
                cfg["projection_class_embeddings_input_dim"], temb)

        def res(cin, cout):
            return Resnet(cin, cout, temb, eps, groups)

        def attn(ch, h, d):
            return Transformer2D(ch, ctx, h, d, linear, groups)

        skips = [c0]
        ch = c0
        self.down_blocks = nn.ModuleList()
        for i, (cout, h, d) in enumerate(levels):
            rs, ats = [], []
            for _ in range(lpb):
                rs.append(res(ch, cout))
                ch = cout
                if d:
                    ats.append(attn(ch, h, d))
                skips.append(ch)
            down = _Conv(ch, True) if i < n - 1 else None
            if down is not None:
                skips.append(ch)
            self.down_blocks.append(_Block(rs, ats, down=down))
        _, h_mid, d_mid = levels[-1]
        mid_depth = cfg.get("transformer_layers_per_block", 1)
        mid_depth = mid_depth if isinstance(mid_depth, int) else mid_depth[-1]
        self.mid_block = _Block([res(ch, ch), res(ch, ch)],
                                [attn(ch, h_mid, mid_depth)])
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            cout, h, d = levels[n - 1 - i]
            rs, ats = [], []
            for _ in range(lpb + 1):
                rs.append(res(ch + skips.pop(), cout))
                ch = cout
                if d:
                    ats.append(attn(ch, h, d))
            up = _Conv(ch, False) if i < n - 1 else None
            self.up_blocks.append(_Block(rs, ats, up=up))
        self.conv_norm_out = nn.GroupNorm(groups, c0, eps=eps)
        self.conv_out = Conv2d(c0, cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, ctx, text_embeds=None, time_ids=None):
        cfg = self.cfg
        c0 = cfg["block_out_channels"][0]
        flip, shift = cfg["flip_sin_to_cos"], cfg["freq_shift"]
        t = t.expand(x.shape[0]) if t.ndim == 0 else t
        temb = self.time_embedding(timestep_embedding(t, c0, flip, shift))
        if hasattr(self, "add_embedding"):
            ids = timestep_embedding(time_ids.reshape(-1),
                                     cfg["addition_time_embed_dim"], flip,
                                     shift).reshape(x.shape[0], -1)
            temb = temb + self.add_embedding(
                torch.cat([text_embeds, ids], -1))
        x = self.conv_in(x)
        skips = [x]
        for blk in self.down_blocks:
            for j, r in enumerate(blk.resnets):
                x = r(x, temb)
                if len(blk.attentions):
                    x = blk.attentions[j](x, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, ctx)
        x = self.mid_block.resnets[1](x, temb)
        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                x = r(torch.cat([x, skips.pop()], 1), temb)
                if len(blk.attentions):
                    x = blk.attentions[j](x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


# ---------------------------------------------------------------------------
# AutoencoderKL
# ---------------------------------------------------------------------------

class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q, self.to_k = Linear(ch, ch), Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.to_out[0](attention(self.to_q(y), self.to_k(y),
                                     self.to_v(y), 1))
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


def _vae_res(cin, cout, groups):
    return Resnet(cin, cout, None, 1e-6, groups)


class Encoder(nn.Module):
    """Present for its parameters (the port's autoencoder holds both
    halves); the benchmark's traffic never encodes."""

    def __init__(self, cfg):
        super().__init__()
        chans, g = cfg["block_out_channels"], cfg["norm_num_groups"]
        ch = chans[0]
        self.conv_in = Conv2d(cfg["in_channels"], ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, cout in enumerate(chans):
            rs = []
            for _ in range(cfg["layers_per_block"]):
                rs.append(_vae_res(ch, cout, g))
                ch = cout
            down = _AsymmetricDown(ch) if i < len(chans) - 1 else None
            self.down_blocks.append(_Block(rs, down=down))
        self.mid_block = _Block([_vae_res(ch, ch, g), _vae_res(ch, ch, g)],
                                [VAEAttention(ch, g)])
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = Conv2d(ch, 2 * cfg["latent_channels"], 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chans, g = cfg["block_out_channels"], cfg["norm_num_groups"]
        n = len(chans)
        ch = chans[-1]
        self.conv_in = Conv2d(cfg["latent_channels"], ch, 3, padding=1)
        self.mid_block = _Block([_vae_res(ch, ch, g), _vae_res(ch, ch, g)],
                                [VAEAttention(ch, g)])
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            cout = chans[n - 1 - i]
            rs = []
            for _ in range(cfg["layers_per_block"] + 1):
                rs.append(_vae_res(ch, cout, g))
                ch = cout
            up = _Conv(ch, False) if i < n - 1 else None
            self.up_blocks.append(_Block(rs, up=up))
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = Conv2d(ch, cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lat = cfg["latent_channels"]
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv2d(lat, lat, 1)

    def decode(self, latents):
        """Scaled latents -> images in about [-1, 1]."""
        z = latents / self.cfg["scaling_factor"]
        return self.decoder(self.post_quant_conv(z))


def build(config: dict) -> dict:
    """The configuration's networks on the meta device, by diffusers
    component name: ``unet``, ``vae``, ``text_encoder`` and, for SDXL,
    ``text_encoder_2``."""
    pipe = config.get("pipeline", {})
    penult = pipe.get("text_hidden") == "penultimate"
    with torch.device("meta"):
        mods = {"unet": UNet(config["unet"]),
                "vae": AutoencoderKL(config["vae"]),
                "text_encoder": CLIPText(config["text_encoder"], penult)}
        if config.get("text_encoder_2"):
            mods["text_encoder_2"] = CLIPText(config["text_encoder_2"],
                                              penult, projection=True)
    return mods
