"""Diffusion samplers: pndm, dpm, ddim, euler, euler_ancestral, lms, unipc
and lcm, the JAX package's eight."""

from .base import Scheduler, SchedulerConfig, get_scheduler

__all__ = ["Scheduler", "SchedulerConfig", "get_scheduler"]
