"""Diffusion samplers: pndm, dpm, ddim, euler, euler_ancestral, lms, unipc
and lcm, the JAX package's eight."""

from .base import Scheduler, SchedulerConfig, get_scheduler

#: every sampler's name, in the JAX package's order
SCHEDULER_NAMES = ("ddim", "pndm", "lms", "euler", "euler_ancestral", "dpm",
                   "unipc", "lcm")

__all__ = ["Scheduler", "SchedulerConfig", "get_scheduler", "SCHEDULER_NAMES"]
