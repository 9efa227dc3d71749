"""Seconds from the process's start to the window's start: imports, the
weights drawn on the card, the port built and the kernel library loaded
(built, in a checkout's first run), and the warm-up at the cell's own
shapes (host clock)."""


def read(obs):
    return obs["setup_s"]
