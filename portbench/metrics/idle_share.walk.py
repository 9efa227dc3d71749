"""Device: 1 - the union of device activity over the profiled stretch's
wall seconds, in percent."""


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
