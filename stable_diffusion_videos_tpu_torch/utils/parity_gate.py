"""The parity gate: a fixed walk against a reference frame dump.

Counterpart of ``stable_diffusion_videos_tpu/utils/parity_gate.py``, the
same walk and the same thresholds.  ``run_parity_gate`` walks
``GATE_PROMPTS`` x ``GATE_SEEDS`` at ``GATE_CONFIG`` on the pipeline, scores
its frames against the reference directory by file name
(``metrics.compare_frame_dirs``) and passes on ``lpips_mean <
LPIPS_PASS`` when LPIPS weights are given, else on ``ssim_mean >
SSIM_PASS``.  The reference side is the same walk recorded by the reference
package (or by this one, on another device):

    python -m stable_diffusion_videos_tpu_torch parity-gate \\
        --checkpoint /ckpts/sd-v1-4 --reference-frames /dumps/reference_walk \\
        --lpips-weights /ckpts/lpips_alex.pth
"""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger("sdv_torch")

#: the gate's fixed walk: both sides generate exactly this
GATE_PROMPTS = ("a photograph of an astronaut riding a horse",
                "a watercolor painting of a fox in a forest")
GATE_SEEDS = (42, 1337)
GATE_CONFIG = dict(num_interpolation_steps=4, num_inference_steps=50,
                   guidance_scale=7.5, fps=5)

#: LPIPS below this: the same image up to floating-point and sampler noise
LPIPS_PASS = 0.1
#: the gate without LPIPS weights
SSIM_PASS = 0.85


def run_parity_gate(pipeline, reference_frames: str, output_dir: str,
                    lpips_weights: str | None = None,
                    lpips_net: str = "alex",
                    height: int | None = None,
                    width: int | None = None) -> dict:
    """Walk the gate on ``pipeline`` into ``output_dir/parity_gate`` and
    compare it with ``reference_frames``; -> the comparison with ``pass``,
    ``gate`` and ``frames_dir``.  LPIPS runs on the pipeline's device."""
    from .metrics import compare_frame_dirs

    ref = Path(reference_frames)
    if not ref.exists():
        raise FileNotFoundError(f"reference frame dir {ref} does not exist")
    pipeline.walk(prompts=list(GATE_PROMPTS), seeds=list(GATE_SEEDS),
                  output_dir=output_dir, name="parity_gate",
                  make_video=False, height=height, width=width,
                  **GATE_CONFIG)
    ours = Path(output_dir) / "parity_gate"
    res = compare_frame_dirs(ours, ref, lpips_weights=lpips_weights,
                             lpips_net=lpips_net,
                             lpips_device=pipeline.device)
    if "lpips_mean" in res:
        res["gate"] = f"lpips_mean < {LPIPS_PASS}"
        res["pass"] = bool(res["lpips_mean"] < LPIPS_PASS)
    else:
        res["gate"] = (f"ssim_mean > {SSIM_PASS} (no LPIPS weights; "
                       "supply --lpips-weights for the LPIPS gate)")
        res["pass"] = bool(res["ssim_mean"] > SSIM_PASS)
    res["frames_dir"] = str(ours)
    logger.info("parity gate %s: %s", "PASS" if res["pass"] else "FAIL",
                res["gate"])
    return res
