"""The command line: ``python -m stable_diffusion_videos_tpu_torch <command>``.

Counterpart of ``stable_diffusion_videos_tpu/__main__.py`` with the
commands ``walk``, ``vid2vid``, ``images``, ``upsample``, ``app`` and
``serve`` and the same options.  ``--device`` is ``cuda`` unless the caller
asks for ``cpu``; without a CUDA device the command stops with an error
rather than run on the CPU unasked.  Without ``--checkpoint`` the pipeline
is the random tiny model.  The JAX command line's ``convert``, ``compare``,
``parity-gate``, ``validate`` and ``bench`` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def _add_common(ap):
    ap.add_argument("--checkpoint", default=None,
                    help="local diffusers-layout dir, hub id, or a single "
                         "original-layout .ckpt/.safetensors file (omit "
                         "for the tiny random model)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pipeline runs (default cuda; cpu only "
                         "when asked)")
    ap.add_argument("--tokenizer-dir", default=None, metavar="DIR",
                    help="vocab.json+merges.txt dir, required with a "
                         "single-file --checkpoint (they carry no vocab)")
    ap.add_argument("--prediction-type", default=None,
                    choices=["epsilon", "v_prediction"],
                    help="single-file checkpoints only: v_prediction for "
                         "v-models (SD2-768); default epsilon")
    ap.add_argument("--scheduler", default="pndm",
                    choices=["pndm", "ddim", "lms", "euler", "unipc",
                             "euler_ancestral", "dpm", "lcm"])
    ap.add_argument("--tiled", action="store_true",
                    help="circular convolutions: seamlessly tileable frames")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="frames a dispatch (default: the model family's, "
                         "8 for SD 1.x/2.x, 1 for SDXL at 1024^2)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance-scale", type=float, default=7.5)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--negative-prompt", default=None)
    ap.add_argument("--ip-adapter", default=None, metavar="CKPT[,ENCODER]",
                    help="IP-Adapter checkpoint (optionally ',<CLIP image "
                         "encoder dir>' to embed --ip-image)")
    ap.add_argument("--ip-image", default=None,
                    help="image prompt (requires --ip-adapter with an "
                         "encoder)")
    ap.add_argument("--ip-scale", type=float, default=1.0)
    ap.add_argument("--prompt-weighting", action="store_true",
                    help="(emphasis:1.3) / [de-emphasis] prompt syntax and "
                         "prompts past 77 tokens (BREAK starts a window)")
    ap.add_argument("--guidance-rescale", type=float, default=0.0,
                    metavar="PHI",
                    help="std-rescaled CFG weight in [0, 1] (0.7 for "
                         "zero-terminal-SNR v-prediction checkpoints)")
    ap.add_argument("--guidance-interval", nargs=2, type=float,
                    default=None, metavar=("LO", "HI"),
                    help="limited-interval CFG: the guidance pair runs for "
                         "the [LO, HI) fraction of steps, cond-only "
                         "elsewhere")
    ap.add_argument("--fast", action="store_true",
                    help="the fast preset: step caching x guidance "
                         "interval at the family's dispatch batch "
                         "(explicit flags override parts of it)")
    ap.add_argument("--step-cache", type=int, default=None, metavar="K",
                    help="DeepCache: recompute the deep UNet trunk every K "
                         "steps (approximate)")
    ap.add_argument("--step-cache-policy", choices=("uniform", "ends"),
                    default="uniform",
                    help="full-trunk placement for --step-cache: every K-th "
                         "step, or the same budget densest at the "
                         "schedule's ends")
    ap.add_argument("--frozen-noise", action="store_true",
                    help="one stochastic-transition noise field for each "
                         "dispatch (lcm, euler_ancestral, ddim eta>0): no "
                         "sampler-noise flicker between frames")
    ap.add_argument("--lora", action="append", default=None,
                    metavar="PATH[:SCALE]",
                    help="kohya/diffusers LoRA .safetensors merged into the "
                         "model; repeatable")
    ap.add_argument("--textual-inversion", action="append", default=None,
                    metavar="PATH[:TOKEN]",
                    help="textual-inversion embedding file (diffusers / "
                         "A1111 .pt / SDXL clip_l+clip_g); repeatable")
    ap.add_argument("--controlnet", action="append", default=None,
                    metavar="PATH",
                    help="diffusers-layout ControlNetModel dir or weights "
                         "file, with --control-image (repeatable, one "
                         "image a net)")
    ap.add_argument("--control-image", action="append", default=None,
                    metavar="IMG",
                    help="conditioning map (canny/depth/pose image) every "
                         "frame follows; repeatable")
    ap.add_argument("--controlnet-scale", action="append", type=float,
                    default=None, metavar="S",
                    help="ControlNet residual weight (repeatable per net, "
                         "default 1.0)")
    ap.add_argument("--freeu", nargs="*", type=float, default=None,
                    metavar="B1 B2 S1 S2",
                    help="FreeU: bare flag = the family's published "
                         "factors, or 4 values")
    ap.add_argument("--tome", nargs="+", type=float, default=None,
                    metavar="RATIO [MAX_LEVEL]",
                    help="ToMe token merging: merge RATIO of the "
                         "self-attention tokens at levels <= MAX_LEVEL "
                         "(default 0, the highest resolution)")


def _fail(message: str):
    print(message, file=sys.stderr)
    raise SystemExit(2)


def _device(args):
    """The torch device the command asked for; ``cuda`` without a CUDA
    device is an error, never a quiet fall back to the CPU."""
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        _fail("no CUDA device is available: pass --device cpu to run on "
              "the CPU")
    return torch.device(args.device)


def _pipeline(args):
    from .pipeline import StableDiffusionWalkPipeline
    device = _device(args)
    kw = dict(scheduler=args.scheduler,
              fast=getattr(args, "fast", False),
              step_cache=getattr(args, "step_cache", None),
              step_cache_policy=getattr(args, "step_cache_policy",
                                        "uniform"),
              guidance_rescale=getattr(args, "guidance_rescale", 0.0),
              frozen_noise=getattr(args, "frozen_noise", False),
              prompt_weighting=getattr(args, "prompt_weighting", False))
    gi = getattr(args, "guidance_interval", None)
    if gi is not None:
        kw["guidance_interval"] = tuple(gi)
    lora = getattr(args, "lora", None)
    if lora:
        from .models.lora_file import parse_lora_arg
        kw["lora"] = [parse_lora_arg(a) for a in lora]
    ti = getattr(args, "textual_inversion", None)
    if ti:
        from .models.textual_inversion import parse_ti_arg
        kw["textual_inversion"] = [parse_ti_arg(a) for a in ti]
    cn = getattr(args, "controlnet", None)
    if cn:
        kw["controlnet"] = cn if len(cn) > 1 else cn[0]
    ipa = getattr(args, "ip_adapter", None)
    if ipa:
        kw["ip_adapter"] = tuple(ipa.split(",", 1)) if "," in ipa else ipa
    if getattr(args, "ip_image", None) and not ipa:
        _fail("--ip-image requires --ip-adapter")
    fu = getattr(args, "freeu", None)
    if fu is not None:
        if len(fu) not in (0, 4):
            _fail("--freeu takes 0 or 4 values (B1 B2 S1 S2)")
        kw["freeu"] = True if len(fu) == 0 else tuple(fu)
    tm = getattr(args, "tome", None)
    if tm:
        if len(tm) not in (1, 2):
            _fail("--tome takes RATIO [MAX_LEVEL]")
        kw["tome"] = (tm[0], int(tm[1])) if len(tm) == 2 else tm[0]
    ci = getattr(args, "control_image", None)
    if ci and not cn:
        _fail("--control-image requires --controlnet")
    if ci and cn and len(ci) != len(cn):
        _fail("need one --control-image per --controlnet")
    if args.checkpoint is None:
        if lora or ti:
            _fail("--lora/--textual-inversion require --checkpoint "
                  "(adapters need a base model)")
        print("no --checkpoint: using the random tiny model (smoke mode)",
              file=sys.stderr)
        return StableDiffusionWalkPipeline.tiny(device, **kw)
    return StableDiffusionWalkPipeline.from_pretrained(
        args.checkpoint, device=device, tiled=args.tiled,
        tokenizer_dir=getattr(args, "tokenizer_dir", None),
        prediction_type=getattr(args, "prediction_type", None), **kw)


def _ctrl_image(args):
    ci = getattr(args, "control_image", None)
    if not ci:
        return None
    return ci if len(ci) > 1 else ci[0]


def _ctrl_scale(args):
    cs = getattr(args, "controlnet_scale", None)
    if not cs:
        return 1.0
    return cs if len(cs) > 1 else cs[0]


def cmd_walk(args):
    pipe = _pipeline(args)
    steps = args.interpolation_steps
    video = pipe.walk(
        prompts=args.prompts, seeds=args.seeds,
        num_interpolation_steps=steps[0] if len(steps) == 1 else steps,
        output_dir=args.output_dir, name=args.name, fps=args.fps,
        num_inference_steps=args.steps, guidance_scale=args.guidance_scale,
        height=args.height, width=args.width, upsample=args.upsample,
        upsample_weights=args.upsample_weights,
        batch_size=args.batch_size, resume=args.resume,
        audio_filepath=args.audio, audio_start_sec=args.audio_start_sec,
        margin=args.margin, smooth=args.smooth,
        negative_prompt=args.negative_prompt,
        control_image=_ctrl_image(args), controlnet_scale=_ctrl_scale(args),
        ip_image=args.ip_image, ip_scale=args.ip_scale)
    print(video)


def cmd_vid2vid(args):
    cv = getattr(args, "control_video", None)
    cfs = getattr(args, "control_from_source", None)
    if (cv or cfs) and not getattr(args, "controlnet", None):
        _fail("--control-video/--control-from-source require --controlnet")
    pipe = _pipeline(args)
    out = pipe.vid2vid(
        args.video, args.prompt, strength=args.strength,
        num_inference_steps=args.steps, guidance_scale=args.guidance_scale,
        negative_prompt=args.negative_prompt, seed=args.seed,
        height=args.height, width=args.width, fps=args.fps,
        batch_size=args.batch_size, frame_skip=args.frame_skip,
        max_frames=args.max_frames, output_filepath=args.output,
        audio_filepath=args.audio, control_video=cv,
        controlnet_scale=_ctrl_scale(args), control_from_source=cfs,
        canny_thresholds=tuple(args.canny_thresholds),
        ip_image=args.ip_image, ip_scale=args.ip_scale,
        shared_noise=not args.per_frame_noise)
    print(out)


def cmd_images(args):
    from .pipeline.image_generation import generate_images
    pipe = _pipeline(args)
    paths = generate_images(
        pipe, args.prompt, batch_size=args.batch_size,
        num_batches=args.num_batches, seeds=args.seeds,
        num_inference_steps=args.steps, guidance_scale=args.guidance_scale,
        output_dir=args.output_dir, name=args.name, upsample=args.upsample,
        upsample_weights=args.upsample_weights,
        height=args.height, width=args.width,
        negative_prompt=args.negative_prompt,
        push_to_hub=args.push_to_hub, repo_id=args.repo_id,
        control_image=_ctrl_image(args), controlnet_scale=_ctrl_scale(args))
    print("\n".join(paths))


def cmd_upsample(args):
    from .pipeline.upsampling import RealESRGANModel
    model = RealESRGANModel.from_pretrained(args.weights, _device(args),
                                            tile=args.tile)
    model.upsample_imagefolder(args.input_dir, args.output_dir)


def cmd_app(args):
    from .app import Interface
    Interface(_pipeline(args)).launch(share=args.share)


def cmd_serve(args):
    from .runtime.server import Server
    Server(_pipeline(args), output_root=args.output_root).serve_forever(
        host=args.host, port=args.port)


def _upsample_args(p):
    p.add_argument("--upsample", action="store_true")
    p.add_argument("--upsample-weights", default=None, metavar="PTH",
                   help="RealESRGAN_x4plus weights file for --upsample (or "
                        "set SDV_REALESRGAN)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="stable_diffusion_videos_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    w = sub.add_parser("walk", help="prompt-walk video")
    _add_common(w)
    w.add_argument("--prompts", nargs="+", required=True)
    w.add_argument("--seeds", nargs="+", type=int, required=True)
    w.add_argument("--interpolation-steps", nargs="+", type=int, default=[30])
    w.add_argument("--output-dir", default="./dreams")
    w.add_argument("--name", default=None)
    w.add_argument("--fps", type=int, default=30)
    _upsample_args(w)
    w.add_argument("--resume", action="store_true")
    w.add_argument("--audio", default=None)
    w.add_argument("--audio-start-sec", type=float, default=None)
    w.add_argument("--margin", type=float, default=1.0)
    w.add_argument("--smooth", type=float, default=0.0)
    w.set_defaults(fn=cmd_walk)

    vv = sub.add_parser("vid2vid", help="restyle a video with img2img "
                                        "(one shared noise field)")
    _add_common(vv)
    vv.add_argument("--video", required=True,
                    help="input video file / frame directory")
    vv.add_argument("--prompt", required=True)
    vv.add_argument("--strength", type=float, default=0.5)
    vv.add_argument("--seed", type=int, default=0)
    vv.add_argument("--fps", type=float, default=None,
                    help="output fps (default: the source's)")
    vv.add_argument("--frame-skip", type=int, default=1)
    vv.add_argument("--max-frames", type=int, default=None)
    vv.add_argument("--output", default="vid2vid.mp4")
    vv.add_argument("--audio", default=None,
                    help="audio file to mux into the output")
    vv.add_argument("--control-video", default=None,
                    help="per-frame ControlNet maps: video file or dir "
                         "(requires --controlnet)")
    vv.add_argument("--control-from-source", default=None,
                    choices=["canny", "identity"],
                    help="ControlNet maps made from the source frames "
                         "(requires --controlnet)")
    vv.add_argument("--canny-thresholds", nargs=2, type=int,
                    default=[100, 200], metavar=("LO", "HI"))
    vv.add_argument("--per-frame-noise", action="store_true",
                    help="a fresh re-noising field a frame (flickers; the "
                         "default is one field for the whole video)")
    vv.set_defaults(fn=cmd_vid2vid)

    im = sub.add_parser("images", help="batch image generation")
    _add_common(im)
    im.add_argument("--prompt", required=True)
    im.add_argument("--num-batches", type=int, default=1)
    im.add_argument("--seeds", nargs="+", type=int, default=None)
    im.add_argument("--output-dir", default="./images")
    im.add_argument("--name", default=None)
    _upsample_args(im)
    im.add_argument("--push-to-hub", action="store_true")
    im.add_argument("--repo-id", default=None)
    im.set_defaults(fn=cmd_images)

    up = sub.add_parser("upsample", help="4x Real-ESRGAN an image folder")
    up.add_argument("--weights", required=True,
                    help="RealESRGAN_x4plus.pth path")
    up.add_argument("--input-dir", required=True)
    up.add_argument("--output-dir", required=True)
    up.add_argument("--tile", type=int, default=0)
    up.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    up.set_defaults(fn=cmd_upsample)

    app = sub.add_parser("app", help="launch the gradio UI")
    _add_common(app)
    app.add_argument("--share", action="store_true")
    app.set_defaults(fn=cmd_app)

    srv = sub.add_parser("serve", help="HTTP JSON inference server")
    _add_common(srv)
    srv.add_argument("--host", default="127.0.0.1",
                     help="bind address (default loopback; pass 0.0.0.0 "
                          "to listen on the network)")
    srv.add_argument("--port", type=int, default=8000)
    srv.add_argument("--output-root", default="./dreams",
                     help="directory every /walk output is confined under")
    srv.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
