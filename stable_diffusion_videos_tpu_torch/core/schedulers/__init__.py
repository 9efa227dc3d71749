"""Diffusion samplers (the port has PNDM and DPM-Solver++ 2M)."""

from .base import Scheduler, SchedulerConfig, get_scheduler

__all__ = ["Scheduler", "SchedulerConfig", "get_scheduler"]
