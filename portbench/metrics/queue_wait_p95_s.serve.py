"""Front end: the 95th percentile (nearest rank) over the window's
requests of the time from a request's due time to the start of the
dispatch that carried it (requests map to dispatches by their seeds)."""

from portbench.stats import percentile


def read(obs):
    waits = obs["window"].get("queue_waits")
    return percentile(waits, 95) if waits else None
