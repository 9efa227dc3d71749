"""The one place the benchmark builds the system under test from a
configuration file: the port's published presets (``family`` names which),
checked against the file's widths, filled with the benchmark's weights
through the port's state-dict loader."""

from __future__ import annotations

import dataclasses

import torch


def _presets(family: str):
    from stable_diffusion_videos_tpu_torch.models.clip_text import \
        CLIPTextConfig
    from stable_diffusion_videos_tpu_torch.models.unet import UNetConfig
    from stable_diffusion_videos_tpu_torch.models.vae import VAEConfig
    table = {
        "sd1": (UNetConfig.sd_v1, VAEConfig.sd_v1, CLIPTextConfig.sd_v1,
                None),
        "sdxl": (UNetConfig.sd_xl, VAEConfig.sd_xl, CLIPTextConfig.sd_xl_l,
                 CLIPTextConfig.sd_xl_g),
        "tiny": (UNetConfig.tiny, VAEConfig.tiny, CLIPTextConfig.tiny, None),
        "tiny_xl": (UNetConfig.tiny_xl, VAEConfig.tiny,
                    CLIPTextConfig.tiny_xl_l, CLIPTextConfig.tiny_xl_g),
    }
    if family not in table:
        raise KeyError(f"no port preset for family {family!r}")
    return [f and f() for f in table[family]]


def modules(config: dict) -> dict:
    """The port's networks of the configuration's family on the meta
    device, by diffusers component name, and their configs."""
    from stable_diffusion_videos_tpu_torch.models.clip_text import \
        CLIPTextEncoder
    from stable_diffusion_videos_tpu_torch.models.unet import UNet2DCondition
    from stable_diffusion_videos_tpu_torch.models.vae import AutoencoderKL
    ucfg, vcfg, tcfg, tcfg2 = _presets(config["family"])
    vcfg = dataclasses.replace(
        vcfg, scaling_factor=config["vae"]["scaling_factor"])
    with torch.device("meta"):
        mods = {"unet": UNet2DCondition(ucfg), "vae": AutoencoderKL(vcfg),
                "text_encoder": CLIPTextEncoder(tcfg)}
        if tcfg2 is not None:
            mods["text_encoder_2"] = CLIPTextEncoder(tcfg2)
    return mods, (ucfg, vcfg, tcfg, tcfg2)


def check_widths(config: dict, reference: dict) -> None:
    """Raise unless the port's modules of the family have exactly the
    parameters, names and shapes, of the reference built from the file."""
    port, (ucfg, _, tcfg, tcfg2) = modules(config)
    from .reference.models import unet_levels
    heads = [h for _, h, _ in unet_levels(config["unet"])]
    towers = [(tcfg, config["text_encoder"])]
    if tcfg2 is not None:
        towers.append((tcfg2, config["text_encoder_2"]))
    if ([ucfg.heads(i) for i in range(len(heads))] != heads or any(
            (t.num_heads, t.hidden_act) != (f["num_attention_heads"],
                                            f["hidden_act"])
            for t, f in towers)):
        raise ValueError(f"{config['name']}: the port's heads or "
                         "activations differ from the configuration file")
    if set(port) != set(reference):
        raise ValueError(f"components {sorted(port)} against "
                         f"{sorted(reference)}")
    for comp, mod in port.items():
        mine = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
        ref = {k: tuple(v.shape) for k, v in
               reference[comp].state_dict().items()}
        # diffusers keeps SDXL's proj_in/proj_out as Linear (C, C); the
        # port holds the same weights as 1x1 convolutions (C, C, 1, 1)
        ref = {k: (s + (1, 1) if k.endswith((".proj_in.weight",
                                             ".proj_out.weight"))
                   and len(s) == 2 else s) for k, s in ref.items()}
        if mine != ref:
            diff = sorted(set(mine.items()) ^ set(ref.items()))[:8]
            raise ValueError(f"{config['name']}: the port's {comp} differs "
                             f"from the configuration file: {diff}")


def bundle(config: dict, weights: dict, device):
    """An ``SDModels`` of the family's presets holding ``weights``."""
    from stable_diffusion_videos_tpu_torch.core.schedulers import \
        SchedulerConfig
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.models.tokenizer import \
        HashTokenizer
    from stable_diffusion_videos_tpu_torch.models.weights import \
        load_state_dict
    mods, (ucfg, vcfg, tcfg, tcfg2) = modules(config)
    for comp, mod in mods.items():
        sd = weights[comp]
        load_state_dict(mod, sd, next(iter(sd.values())).dtype)
        mod.eval().requires_grad_(False)
    s = config["scheduler"]
    sched = SchedulerConfig(
        num_train_timesteps=s["num_train_timesteps"],
        beta_start=s["beta_start"], beta_end=s["beta_end"],
        beta_schedule=s["beta_schedule"], steps_offset=s["steps_offset"],
        set_alpha_to_one=s["set_alpha_to_one"],
        prediction_type=s.get("prediction_type", "epsilon"),
        timestep_spacing=s.get("timestep_spacing", "leading"))
    models = SDModels(ucfg, vcfg, tcfg, mods["unet"], mods["vae"],
                      mods["text_encoder"],
                      HashTokenizer(vocab_size=tcfg.vocab_size), sched)
    if tcfg2 is not None:
        models = dataclasses.replace(
            models, text_config_2=tcfg2,
            text_encoder_2=mods["text_encoder_2"],
            tokenizer_2=HashTokenizer(
                vocab_size=tcfg2.vocab_size,
                pad_token_id=config["pipeline"]["pad_token_id_2"]))
    return models.to(torch.device(device))
