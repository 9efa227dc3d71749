"""The requests whose whole reply arrived inside the window, over the
window's seconds (host clock): above capacity, the rate the server
completes."""


def read(obs):
    w = obs["window"]
    return w["completed"] / w["seconds"] if "completed" in w else None
