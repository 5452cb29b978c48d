"""Architecture configs and shape sets (the port's own copy of
``repro.configs``)."""

from .base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    get_config,
    register,
    shape_applicable,
)

# The architectures the dry run covers (``launch.dryrun --all``).
ASSIGNED = (
    "musicgen-medium",
    "olmo-1b",
    "deepseek-67b",
    "qwen3-14b",
    "gemma2-27b",
    "granite-moe-1b-a400m",
    "grok-1-314b",
    "internvl2-1b",
    "jamba-1.5-large-398b",
    "mamba2-370m",
)

__all__ = [
    "ASSIGNED",
    "SHAPES",
    "ArchConfig",
    "ShapeSpec",
    "get_config",
    "register",
    "shape_applicable",
]
