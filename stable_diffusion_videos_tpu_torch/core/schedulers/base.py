"""Scheduler core — host-precomputed tables, steps as pure functions of the
loop index.

Counterpart of ``stable_diffusion_videos_tpu/core/schedulers/base.py``.
``make_tables(config, num_inference_steps)`` runs once on the host in
float64 numpy; ``step(tables, state, i, model_output, sample)`` is a pure
function of the loop index ``i``, called from a Python loop (the JAX
package's ``lax.scan``).  Per-step coefficients are read on the host as
Python floats, so a step launches no device-to-host copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static sampler configuration (mirrors the SD v1.x scheduler config)."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    #: "leading" (the SD checkpoints) or "linspace"; DPM-Solver++ reads it
    timestep_spacing: str = "leading"
    set_alpha_to_one: bool = False
    # PNDM
    skip_prk_steps: bool = True
    # DPM-Solver++ 2M (data prediction, second order: the only variant the
    # port has, so it takes no order or algorithm setting)
    lower_order_final: bool = True


def betas_for_schedule(cfg: SchedulerConfig) -> np.ndarray:
    """Training beta schedule -> float64 numpy."""
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                           dtype=np.float64) ** 2
    raise ValueError(f"unknown beta_schedule {cfg.beta_schedule!r}")


def alphas_cumprod_for(cfg: SchedulerConfig) -> np.ndarray:
    return np.cumprod(1.0 - betas_for_schedule(cfg))


def check_num_steps(cfg: SchedulerConfig, num_inference_steps: int):
    if not 1 <= num_inference_steps <= cfg.num_train_timesteps:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} must be in "
            f"[1, num_train_timesteps={cfg.num_train_timesteps}]")


class Scheduler:
    """Interface shared by the samplers.  Subclasses are stateless
    namespaces; all data lives in (tables, state)."""

    name: str = "base"

    def make_tables(self, cfg: SchedulerConfig, num_inference_steps: int):
        raise NotImplementedError

    def init_state(self, tables, latents):
        return {}

    def init_noise_sigma(self, tables) -> float:
        return float(tables["init_noise_sigma"])

    def scale_model_input(self, tables, state, i, sample):
        return sample

    def timestep(self, tables, i) -> int:
        """The training timestep fed to the UNet at loop index ``i``."""
        return int(tables["timesteps"][i])

    def num_loop_steps(self, tables) -> int:
        return len(tables["timesteps"])

    def step(self, tables, state, i, model_output, sample):
        raise NotImplementedError


_REGISTRY: dict[str, Any] = {}


def register(cls):
    _REGISTRY[cls.name] = cls()
    return cls


def get_scheduler(name: str) -> Scheduler:
    """Look up a sampler by name; the port has 'pndm' and 'dpm'."""
    from . import dpm, pndm  # noqa: F401  (registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
