"""Every frame the window's walks wrote, over all the time from the first
walk's call to the last walk's return (host clock)."""


def read(obs):
    w = obs["window"]
    return w["frames"] / w["seconds"] if "frames" in w else None
