"""Engine: the model FLOPs of the window's walks (text towers, every UNet
call at its CFG rows, the decodes; ``portbench/flops.py`` from the
configuration's shapes) over the window's wall seconds, as a percent of
one H100's dense bf16 peak (989 TFLOP/s)."""

from portbench.flops import PEAK_FLOPS


def read(obs):
    w = obs["window"]
    if not w.get("model_flops"):
        return None
    return 100.0 * w["model_flops"] / w["seconds"] / PEAK_FLOPS
