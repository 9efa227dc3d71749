"""The benchmark's plain reference: float32 PyTorch, TF32 off, nothing of
the port and nothing of JAX.  ``frames`` works out the frames that the
timed path produced from the same inputs: the configuration, the weights
the benchmark drew and each frame's prompts, seeds and position on its
walk.  With ``control`` the same computation runs with every linear
layer's and convolution's weight and input rounded to float8 e4m3 (the
precision below the configuration's bfloat16): the reading that a
correct run must stay well below."""

from __future__ import annotations

import torch

from . import models, pipeline


def build(config: dict, state_dicts: dict, device) -> dict:
    """The configuration's networks in float32 on ``device``, filled from
    ``state_dicts`` (diffusers names, by component)."""
    mods = models.build(config)
    for name, mod in mods.items():
        sd = {k: v.to(device=device, dtype=torch.float32)
              for k, v in state_dicts[name].items()}
        mod.load_state_dict(sd, strict=True, assign=True)
        mod.eval().requires_grad_(False)
    return mods


def frames(config: dict, mods: dict, spec: dict, items: list, device,
           control: bool = False, block: int = 4) -> torch.Tensor:
    """uint8 (N, H, W, 3) frames of ``items`` on ``device``.

    ``spec``: sampler, steps, guidance, cfg, latent (h, w).  Each item:
    prompt_a, prompt_b, seed_a, seed_b, t (the frame's position between
    them: embeddings lerped, noise slerped; a single prompt and seed when
    a == b and t == 0), and ``noise_key`` for a frozen stochastic sampler
    (one field a step from a generator on ``device`` seeded with it)."""
    models.QUANT = models.fp8_fake if control else None
    try:
        # blocks of consecutive items that share a noise key
        blocks, cur = [], []
        for it in items:
            if cur and (len(cur) == block or it.get("noise_key")
                        != cur[0].get("noise_key")):
                blocks.append(cur)
                cur = []
            cur.append(it)
        blocks += [cur] if cur else []
        with pipeline.float32_mode():
            return torch.cat([_block(config, mods, spec, b, device)
                              for b in blocks])
    finally:
        models.QUANT = None


def _block(config, mods, spec, items, device):
    h, w = spec["latent"]
    c = config["unet"]["in_channels"]
    prompts = sorted({it["prompt_a"] for it in items}
                     | {it["prompt_b"] for it in items} | {""})
    ctx, pooled = pipeline.encode_prompts(mods, config, prompts, device)
    row = {p: i for i, p in enumerate(prompts)}
    cond, pool, noise = [], [], []
    for it in items:
        t = float(it["t"])
        a, b = row[it["prompt_a"]], row[it["prompt_b"]]
        cond.append(pipeline.lerp(t, ctx[a], ctx[b]))
        if pooled is not None:
            pool.append(pipeline.lerp(t, pooled[a], pooled[b]))
        na = pipeline.noise_for_seed(it["seed_a"], (1, c, h, w))
        nb = pipeline.noise_for_seed(it["seed_b"], (1, c, h, w))
        noise.append(pipeline.slerp(t, na, nb).to(device))
    fields = None
    key = items[0].get("noise_key")
    if key is not None:
        gen = torch.Generator(device).manual_seed(int(key))
        fields = [torch.randn((1, c, h, w), generator=gen, device=device,
                              dtype=torch.float32)
                  for _ in range(spec["steps"])]
    un = ctx[row[""]][None]
    up = None if pooled is None else pooled[row[""]][None]
    return pipeline.denoise(
        mods, config, spec, torch.stack(cond),
        un, None if pooled is None else torch.stack(pool), up,
        torch.cat(noise), fields)
