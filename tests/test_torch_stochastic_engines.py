"""The PyTorch package's engine against the JAX package's with the
stochastic samplers: ddim at eta 0.5, euler_ancestral and lcm, under CFG on
the tiny geometry (``tests/test_torch_distilled.py`` runs lcm under
``frozen_noise`` through both engines).

The port engine draws nothing here: its callable noise source replays the
JAX engine's key chain (``JaxNoise``), a field of the padded batch a step.
Float frames must agree within 1e-4.  The weights and
helpers are those of ``tests/test_torch_sampler_engines.py``.
"""

import numpy as np
import pytest

from test_torch_sampler_engines import (ENGINE_TOL, engine_frames,
                                        tiny_bundles)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


@pytest.mark.parametrize("scheduler,run", [
    ("ddim", dict(eta=0.5)), ("euler_ancestral", {}), ("lcm", {})],
    ids=["ddim_eta05", "euler_ancestral", "lcm"])
def test_engine_matches_jax(bundles, scheduler, run):
    got, want = engine_frames(bundles, scheduler, run)
    np.testing.assert_allclose(got, want, **ENGINE_TOL)
