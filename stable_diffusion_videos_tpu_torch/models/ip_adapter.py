"""IP-Adapter: image-prompt conditioning (Ye et al. 2023), PyTorch.

Counterpart of ``stable_diffusion_videos_tpu/models/ip_adapter.py``: a
projection maps one CLIP image embedding to ``num_tokens`` tokens
(``ImageProjection``: Linear, reshape, LayerNorm), and every UNet
cross-attention gets bias-free ``to_k_ip``/``to_v_ip`` projections whose
attention over those tokens, times a scale, is added to the text attention
(``layers.CrossAttention``).  ``IPAdapter.splice`` adds the projections to a
copy of the bundle's UNet that shares every other weight; the tokens reach
the UNet as ``ip_context``.

Checkpoints (``ip-adapter_sd15.bin`` and its safetensors form) hold
``image_proj.{proj,norm}.*`` and ``ip_adapter.{i}.to_{k,v}_ip.weight``,
where ``i`` enumerates diffusers' ``unet.attn_processors``: down blocks by
level, up blocks deepest first, the mid block last, self- and
cross-attention in turn, so the cross-attentions sit at the odd indices
(``attn2_scopes``).  The image tower is ``models/safety.py``'s, loaded from
a transformers ``CLIPVisionModelWithProjection`` directory.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .safety import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, CLIPVisionConfig,
                     CLIPVisionEncoder)
from .weights import (clip_vision, find_weights_file, load_state_dict,
                      random_state_dict, read_safetensors, read_weights,
                      shared_copy)


def preprocess_clip_image(images: torch.Tensor,
                          image_size: int) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] -> CLIP-normalised (B, 3, S, S), as
    ``CLIPImageProcessor``: the shortest side resized to ``image_size``
    (Keys cubic, a = -0.5, antialiased when it shrinks, as the JAX
    package's ``jax.image.resize(..., "cubic")``), then the centre crop."""
    b, h, w, _ = images.shape
    if h <= w:
        nh, nw = image_size, max(image_size, int(round(w * image_size / h)))
    else:
        nw, nh = image_size, max(image_size, int(round(h * image_size / w)))
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(nh, nw),
                      mode="bicubic", antialias=True, align_corners=False)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, top:top + image_size, left:left + image_size]
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)[:, None, None]
    return (x.clamp(0.0, 1.0) - mean) / std


class ImageProjection(nn.Module):
    """CLIP image embedding (B, E) -> (B, num_tokens, cross_attention_dim)
    tokens (the published ImageProjModel)."""

    def __init__(self, embed_dim: int, cross_attention_dim: int,
                 num_tokens: int = 4):
        super().__init__()
        self.num_tokens, self.cross_attention_dim = (num_tokens,
                                                     cross_attention_dim)
        self.proj = nn.Linear(embed_dim, cross_attention_dim * num_tokens)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=1e-5)

    def forward(self, image_embeds):
        x = self.proj(image_embeds).reshape(
            image_embeds.shape[0], self.num_tokens, self.cross_attention_dim)
        return self.norm(x)


def attn2_scopes(cfg) -> List[Tuple[str, int]]:
    """(module name, level) of every cross-attention of the UNet, in the
    order of diffusers' attention processors: down blocks by level, up
    blocks deepest first, the mid block last, each transformer's blocks in
    turn."""
    n = len(cfg.block_out_channels)
    scopes = []

    def transformer(prefix, level):
        for d in range(cfg.depth(level)):
            scopes.append((f"{prefix}.transformer_blocks.{d}.attn2", level))

    for level in range(n):
        if cfg.attn_levels[level]:
            for j in range(cfg.layers_per_block):
                transformer(f"down_blocks.{level}.attentions.{j}", level)
    for i in range(n):
        level = n - 1 - i
        if cfg.attn_levels[level]:
            for j in range(cfg.layers_per_block + 1):
                transformer(f"up_blocks.{i}.attentions.{j}", level)
    transformer("mid_block.attentions.0", n - 1)
    return scopes


class IPAdapter:
    """An IP-Adapter: the projection, one ``(to_k_ip, to_v_ip)`` weight
    pair ((inner, cross_attention_dim) each, PyTorch Linear layout) per
    ``attn2_scopes`` entry, and optionally the image tower
    (``CLIPVisionEncoder`` with its projection).  Without a tower,
    ``image_tokens`` takes precomputed image embeddings."""

    def __init__(self, proj: ImageProjection, kv: List[tuple],
                 image_encoder: Optional[CLIPVisionEncoder] = None):
        self.proj = proj.eval().requires_grad_(False)
        self.kv = [(k, v) for k, v in kv]
        self.image_encoder = (None if image_encoder is None else
                              image_encoder.eval().requires_grad_(False))
        self._uncond = None

    @property
    def embed_dim(self) -> int:
        return self.proj.proj.in_features

    @property
    def device(self) -> torch.device:
        return self.proj.proj.weight.device

    def to(self, device: torch.device) -> "IPAdapter":
        """Move the projection and the tower to ``device`` (in place)."""
        self.proj.to(device)
        if self.image_encoder is not None:
            self.image_encoder.to(device)
        self._uncond = None
        return self

    # ------------------------------------------------------------------
    def splice(self, models):
        """``models`` with a UNet copy whose cross-attentions carry this
        adapter's ``to_k_ip``/``to_v_ip``, in the UNet's dtype and on its
        device; every other weight is shared with ``models``."""
        cfg = models.unet_config
        scopes = attn2_scopes(cfg)
        if len(scopes) != len(self.kv):
            raise ValueError(f"adapter has {len(self.kv)} attention layers, "
                             f"the UNet config needs {len(scopes)}")
        unet = shared_copy(models.unet)
        ref = unet.conv_in.weight
        for (name, level), (k, v) in zip(scopes, self.kv):
            inner = cfg.block_out_channels[level]
            if tuple(k.shape) != (inner, cfg.cross_attention_dim) or \
                    tuple(v.shape) != tuple(k.shape):
                raise ValueError(
                    f"{name}: IP-Adapter weights are {tuple(k.shape)}, the "
                    f"UNet needs ({inner}, {cfg.cross_attention_dim}): the "
                    "wrong adapter for this model?")
            attn = unet.get_submodule(name)
            for attr, w in (("to_k_ip", k), ("to_v_ip", v)):
                lin = nn.Linear(w.shape[1], w.shape[0], bias=False,
                                device="meta")
                lin.weight = nn.Parameter(
                    w.to(device=ref.device, dtype=ref.dtype),
                    requires_grad=False)
                setattr(attn, attr, lin)
        return dataclasses.replace(models, unet=unet)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def uncond_tokens(self) -> torch.Tensor:
        """The negative image prompt: the projection of a zero embedding
        (the published formulation, not zero tokens), (1, T, D) float32."""
        if self._uncond is None:
            self._uncond = self.proj(torch.zeros(
                1, self.embed_dim, device=self.device,
                dtype=self.proj.proj.weight.dtype)).float()
        return self._uncond

    @torch.no_grad()
    def image_tokens(self, image=None, image_embeds=None) -> torch.Tensor:
        """(B, num_tokens, cross_attention_dim) float32 tokens on the
        adapter's device, from an image (a path, PIL image, or (H, W, 3) /
        (B, H, W, 3) array, uint8 or in [0, 1]) through the tower, or from
        (B, embed_dim) ``image_embeds``."""
        if image_embeds is None:
            if self.image_encoder is None:
                raise ValueError("this IPAdapter has no image encoder: pass "
                                 "image_embeds=")
            from PIL import Image
            if isinstance(image, (str, Path)):
                image = Image.open(image)
            if isinstance(image, Image.Image):
                image = np.asarray(image.convert("RGB"), np.float32) / 255.0
            image = np.asarray(image, np.float32)
            if image.max() > 1.5:
                image = image / 255.0
            if image.ndim == 3:
                image = image[None]
            enc = self.image_encoder
            pix = preprocess_clip_image(
                torch.as_tensor(image, device=self.device),
                enc.config.image_size)
            image_embeds = enc(pix.to(enc.visual_projection.weight.dtype))
        x = torch.as_tensor(image_embeds, device=self.device)
        return self.proj(x.to(self.proj.proj.weight.dtype)).float()

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, unet_config, embed_dim: int, num_tokens: int,
              state: dict, vision: Optional[tuple] = None) -> "IPAdapter":
        """From a flat state dict (``image_proj.*``, ``ip_adapter.{2i+1}.
        to_{k,v}_ip.weight``) and optionally (tower config, tower state
        dict with ``visual_projection.weight``)."""
        proj = ImageProjection(embed_dim, unet_config.cross_attention_dim,
                               num_tokens)
        load_state_dict(proj, {k[len("image_proj."):]: v
                               for k, v in state.items()
                               if k.startswith("image_proj.")},
                        torch.float32)
        def weight(key):
            w = state[key]
            return (w.float() if torch.is_tensor(w)
                    else torch.from_numpy(np.array(w, np.float32)))

        # the cross-attention processors sit at the odd indices
        kv = [(weight(f"ip_adapter.{2 * i + 1}.to_k_ip.weight"),
               weight(f"ip_adapter.{2 * i + 1}.to_v_ip.weight"))
              for i in range(len(attn2_scopes(unet_config)))]
        encoder = None
        if vision is not None:
            vcfg, vsd = vision
            with torch.device("meta"):
                encoder = CLIPVisionEncoder(vcfg)
            load_state_dict(encoder, vsd, torch.float32)
        return cls(proj, kv, encoder)

    @classmethod
    def random(cls, unet_config, seed: int = 6,
               vision: Optional[CLIPVisionConfig] = None,
               embed_dim: int = 1024,
               device: Optional[torch.device] = None) -> "IPAdapter":
        """Random fp32 weights drawn N(0, 0.02) from numpy seeds ``seed``
        (the projection and K/V) and ``seed + 1`` (the tower, when
        ``vision`` is given): with ``UNetConfig.sd_v1()`` and
        ``CLIPVisionConfig.vit_h14()`` the published widths of
        ip-adapter_sd15 (4 tokens, 1024 -> 4·768) and its image encoder.
        With ``device`` the tower is drawn there from a ``torch.Generator``
        seeded with ``seed + 1`` (``random_state_dict``'s device route) and
        the adapter is moved onto it."""
        rng, std, num_tokens = np.random.default_rng(seed), 0.02, 4
        state = {
            "image_proj.proj.weight": rng.standard_normal(
                (unet_config.cross_attention_dim * num_tokens, embed_dim),
                dtype=np.float32) * std,
            "image_proj.proj.bias": np.zeros(
                unet_config.cross_attention_dim * num_tokens, np.float32),
            "image_proj.norm.weight": np.ones(
                unet_config.cross_attention_dim, np.float32),
            "image_proj.norm.bias": np.zeros(
                unet_config.cross_attention_dim, np.float32)}
        for i, (_, level) in enumerate(attn2_scopes(unet_config)):
            shape = (unet_config.block_out_channels[level],
                     unet_config.cross_attention_dim)
            for p in ("k", "v"):
                state[f"ip_adapter.{2 * i + 1}.to_{p}_ip.weight"] = \
                    rng.standard_normal(shape, dtype=np.float32) * std
        tower = None
        if vision is not None:
            with torch.device("meta"):
                shapes = CLIPVisionEncoder(vision)
            tower = (vision, random_state_dict(shapes, seed + 1, std,
                                               device=device))
        adapter = cls.build(unet_config, embed_dim, num_tokens, state, tower)
        return adapter if device is None else adapter.to(device)

    @classmethod
    def from_jax_params(cls, unet_config, ip) -> "IPAdapter":
        """The JAX package's ``IPAdapter`` (its projection tree, K/V
        kernels and, if present, its tower's tree and projection matrix;
        its tower computes quick_gelu) -> the port's adapter."""
        p = ip.proj_params["params"]
        state = {"image_proj.proj.weight": np.asarray(p["proj"]["kernel"]).T,
                 "image_proj.proj.bias": np.asarray(p["proj"]["bias"]),
                 "image_proj.norm.weight": np.asarray(p["norm"]["scale"]),
                 "image_proj.norm.bias": np.asarray(p["norm"]["bias"])}
        for i, (k, v) in enumerate(ip.attn_kernels):
            state[f"ip_adapter.{2 * i + 1}.to_k_ip.weight"] = np.asarray(k).T
            state[f"ip_adapter.{2 * i + 1}.to_v_ip.weight"] = np.asarray(v).T
        vision = None
        if ip.vision_params is not None:
            jc = ip.vision_config
            vcfg = CLIPVisionConfig(
                image_size=jc.image_size, patch_size=jc.patch_size,
                hidden_size=jc.hidden_size,
                intermediate_size=jc.intermediate_size,
                num_layers=jc.num_layers, num_heads=jc.num_heads,
                projection_dim=np.asarray(
                    ip.vision_params["projection"]).shape[1],
                layer_norm_eps=jc.layer_norm_eps, hidden_act="quick_gelu")
            vision = (vcfg, jax_vision_state_dict(
                ip.vision_params["encoder"], ip.vision_params["projection"],
                vcfg))
        return cls.build(unet_config, int(ip.embed_dim), int(ip.num_tokens),
                         state, vision)


def jax_vision_state_dict(tree: dict, projection, config) -> dict:
    """The JAX ``CLIPVisionEncoder`` tree and (hidden, projection) matrix
    -> transformers ``CLIPVisionModelWithProjection`` names."""
    out = {}
    clip_vision(tree["params"], "vision_model.", config.num_layers, out)
    out["visual_projection.weight"] = np.asarray(projection).T
    return out


def _load_ip_state(path) -> dict:
    """An IP-Adapter checkpoint -> a flat ``group.key`` dict: a
    safetensors file is flat already, a ``.bin`` nests ``image_proj`` and
    ``ip_adapter``."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return read_safetensors(path)[0]
    flat = {}
    for group, sub in read_weights(path).items():
        if isinstance(sub, dict):
            flat.update({f"{group}.{k}": v for k, v in sub.items()})
        else:
            flat[group] = sub
    return flat


def load_clip_vision_tower(encoder_dir) -> tuple:
    """A transformers ``CLIPVisionModelWithProjection`` directory ->
    (config with its ``hidden_act``, state dict)."""
    encoder_dir = Path(encoder_dir)
    config = CLIPVisionConfig.from_json(
        json.loads((encoder_dir / "config.json").read_text()))
    sd = read_weights(find_weights_file(encoder_dir))
    # a buffer of older transformers releases, no weight
    sd.pop("vision_model.embeddings.position_ids", None)
    return config, sd


def load_ip_adapter(path, models, image_encoder=None,
                    num_tokens: int = 4) -> IPAdapter:
    """An IP-Adapter checkpoint (``image_proj`` and ``ip_adapter`` groups,
    ``.bin`` or ``.safetensors``) for ``models``'s UNet, with the image tower
    of the ``image_encoder`` directory if given (else ``image_tokens``
    takes precomputed embeddings)."""
    sd = _load_ip_state(path)
    if "image_proj.proj.weight" not in sd:
        raise ValueError(f"{path} is not an IP-Adapter checkpoint (it needs "
                         "the image_proj and ip_adapter groups)")
    scopes = attn2_scopes(models.unet_config)
    n_ckpt = sum(1 for k in sd if k.endswith(".to_k_ip.weight"))
    if n_ckpt != len(scopes):
        raise ValueError(f"checkpoint has {n_ckpt} attention layers; this "
                         f"UNet needs {len(scopes)}: the wrong adapter for "
                         "this model?")
    embed_dim = sd["image_proj.proj.weight"].shape[1]
    vision = (load_clip_vision_tower(image_encoder)
              if image_encoder is not None else None)
    return IPAdapter.build(models.unet_config, embed_dim, num_tokens, sd,
                           vision)
