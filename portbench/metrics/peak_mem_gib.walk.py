"""Device: ``torch.cuda.max_memory_allocated()`` over the window, after a
reset at its start (the weights included), in GiB."""


def read(obs):
    peak = obs.get("memory_peak")
    return peak / 2 ** 30 if peak else None
