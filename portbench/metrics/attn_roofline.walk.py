"""Kernels: the bound time of the profiled stretch's attention calls
(``portbench/flops.py``, reckoned from the configuration's shapes:
max(4·B·H·Sq·Sk·D / 989 TFLOP/s, bytes of q, k, v, o / 3.35 TB/s)) over
the device time of the attention family, in percent."""

from portbench.flops import attention_bound


def read(obs):
    tr = obs.get("trace")
    busy = tr and tr["families"].get("attention")
    if not busy or not tr["work"].attention:
        return None
    return 100.0 * attention_bound(tr["work"].attention) / busy
