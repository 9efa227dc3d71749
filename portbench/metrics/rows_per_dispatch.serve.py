"""Front end: the mean number of requests the batcher merged into one
dispatch over the window (the benchmark's wrapper of
``server.batcher.dispatch``)."""


def read(obs):
    rows = obs["window"].get("dispatch_rows")
    return sum(rows) / len(rows) if rows else None
