from .base import ArchConfig, MoEArch, ShapeSpec, SHAPES, applicable_shapes  # noqa: F401
