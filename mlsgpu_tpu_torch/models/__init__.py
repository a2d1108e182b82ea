"""Implicit-surface fit models: algebraic sphere and plane fits over
weighted moments (port of mlsgpu_tpu/models)."""

from mlsgpu_tpu_torch.models.sphere import sphere_distance
from mlsgpu_tpu_torch.models.plane import plane_distance

FIT_MODELS = {"sphere": sphere_distance, "plane": plane_distance}

__all__ = ["sphere_distance", "plane_distance", "FIT_MODELS"]
