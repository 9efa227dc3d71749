"""Front end: the 95th percentile (nearest rank) of every request due in
the window, from its due time to its whole reply; a failed request
counts with the time the run waited for it (host clock).  Above
capacity it grows with the backlog."""

from portbench.stats import percentile


def read(obs):
    lat = obs["window"].get("latencies")
    return percentile(lat, 95) if lat else None
