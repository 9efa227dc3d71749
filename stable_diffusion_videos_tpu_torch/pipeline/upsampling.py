"""RealESRGANModel: 4x frame upsampling with RRDBNet, PyTorch.

Counterpart of ``stable_diffusion_videos_tpu/pipeline/upsampling.py``:
frames stay RGB and on the model's device, a whole batch a call, spatially
tiled (``tile`` pixels, ``tile_pad`` of context a side) when the caller asks
for it.  Weights come from a local ``.pth``/``.safetensors`` file
(``models/weights.py`` ``load_realesrgan``); nothing is downloaded.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
from PIL import Image

from ..models.rrdbnet import RRDBNet, RRDBNetConfig
from ..models.weights import (load_realesrgan, load_state_dict,
                              random_state_dict)

logger = logging.getLogger("sdv_torch")


class RealESRGANModel:
    def __init__(self, config: RRDBNetConfig, state_dict: dict,
                 device: torch.device, tile: int = 0, tile_pad: int = 10,
                 dtype: torch.dtype = torch.float32):
        """``device`` is where the net runs and where a tensor given to it
        must lie; ``dtype`` is the convolutions' (fp32 by default, as the
        JAX package's); the output is fp32 either way."""
        self.config = config
        with torch.device("meta"):
            net = RRDBNet(config)
        self.net = load_state_dict(net, state_dict, dtype).eval() \
            .requires_grad_(False).to(device)
        self.device = self.net.conv_first.weight.device
        self.tile = tile
        self.tile_pad = tile_pad

    @classmethod
    def from_pretrained(cls, path: Optional[str], device: torch.device,
                        tile: int = 0, tile_pad: int = 10,
                        dtype: torch.dtype = torch.float32
                        ) -> "RealESRGANModel":
        """A local Real-ESRGAN checkpoint (``RealESRGAN_x4plus.pth`` or
        another RRDBNet; the geometry comes from its tensors), on
        ``device``."""
        if path is None:
            raise FileNotFoundError(
                "RealESRGAN weights are required for upsampling: pass "
                "from_pretrained(path_to_RealESRGAN_x4plus.pth); nothing is "
                "downloaded")
        config, sd = load_realesrgan(path)
        return cls(config, sd, device, tile, tile_pad, dtype)

    @classmethod
    def tiny(cls, device: torch.device, seed: int = 0,
             **kw) -> "RealESRGANModel":
        """A random tiny model (weights N(0, 0.05) from a numpy seed) on
        ``device``."""
        cfg = RRDBNetConfig.tiny()
        with torch.device("meta"):
            shapes = RRDBNet(cfg)
        return cls(cfg, random_state_dict(shapes, seed, 0.05), device, **kw)

    @torch.no_grad()
    def _run(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> fp32 (B, sH, sW, 3) in [0, 1] on the
        model's device, in ``tile`` x ``tile`` pieces when ``tile`` is
        set.  A batch on another device raises: frames are not copied
        between the host and the card behind the caller's back."""
        if batch.device != self.device:
            raise ValueError(f"frames on {batch.device}, upsampler on "
                             f"{self.device}: build the upsampler on the "
                             "frames' device")
        x = batch.permute(0, 3, 1, 2)
        if not self.tile:
            return self.net(x).permute(0, 2, 3, 1)
        b, c, h, w = x.shape
        s, t, pad = self.config.scale, self.tile, self.tile_pad
        out = torch.empty((b, c, h * s, w * s), device=self.device)
        for y0 in range(0, h, t):
            for x0 in range(0, w, t):
                y1, x1 = min(y0 + t, h), min(x0 + t, w)
                yp0, xp0 = max(y0 - pad, 0), max(x0 - pad, 0)
                yp1, xp1 = min(y1 + pad, h), min(x1 + pad, w)
                piece = self.net(x[:, :, yp0:yp1, xp0:xp1])
                oy, ox = (y0 - yp0) * s, (x0 - xp0) * s
                out[:, :, y0 * s:y1 * s, x0 * s:x1 * s] = piece[
                    :, :, oy:oy + (y1 - y0) * s, ox:ox + (x1 - x0) * s]
        return out.permute(0, 2, 3, 1)

    def __call__(self, image: Union[Image.Image, np.ndarray, torch.Tensor]):
        """PIL -> PIL (upscaled), a float (B, H, W, 3) array in [0, 1] ->
        a float32 array (both copied to the model's device and back), a
        tensor on the model's device -> an fp32 tensor there."""
        if isinstance(image, Image.Image):
            arr = np.asarray(image.convert("RGB"), np.float32)[None] / 255.0
            out = self._run(torch.from_numpy(arr).to(self.device))[0]
            return Image.fromarray(torch.round(out * 255.0).to(torch.uint8)
                                   .cpu().numpy())
        if torch.is_tensor(image):
            return self._run(image.float())
        return self._run(torch.from_numpy(np.asarray(image, np.float32))
                         .to(self.device)).cpu().numpy()

    forward = __call__

    def upsample_imagefolder(self, in_dir, out_dir, suffix: str = "out"):
        """Upsample every .png/.jpg/.jpeg/.webp image of ``in_dir`` into
        ``out_dir`` as ``{stem}_{suffix}{ext}``."""
        in_dir, out_dir = Path(in_dir), Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        exts = {".png", ".jpg", ".jpeg", ".webp"}
        paths = sorted(p for p in in_dir.iterdir() if p.suffix.lower() in exts)
        for p in paths:
            out = self(Image.open(p))
            stem = f"{p.stem}_{suffix}" if suffix else p.stem
            out.save(out_dir / f"{stem}{p.suffix}")
        logger.info("upsampled %d images -> %s", len(paths), out_dir)
