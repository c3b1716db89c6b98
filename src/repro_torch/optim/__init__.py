"""Optimizers: the port of the reference's ``repro/optim``."""

from .adamw import adamw_init, adamw_update

__all__ = ["adamw_init", "adamw_update"]
