"""``python3 -m portbench``: see ``portbench/run.py``."""

import time

T0 = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402

from .run import main  # noqa: E402

sys.exit(main(t0=T0))
