"""Architecture configs (the port's own copy of ``repro.configs``)."""

from .base import ArchConfig, get_config, register

__all__ = ["ArchConfig", "get_config", "register"]
