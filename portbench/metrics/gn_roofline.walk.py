"""Kernels: the bound time of the profiled stretch's GroupNorm(+SiLU)
calls (the input read once, the output written once, at 3.35 TB/s;
``portbench/flops.py`` from the configuration's shapes) over the device
time of the GroupNorm family, in percent."""

from portbench.flops import groupnorm_bound


def read(obs):
    tr = obs.get("trace")
    busy = tr and tr["families"].get("groupnorm")
    if not busy or not tr["work"].groupnorm:
        return None
    return 100.0 * groupnorm_bound(tr["work"].groupnorm) / busy
