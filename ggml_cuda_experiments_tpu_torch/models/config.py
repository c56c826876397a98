"""Model configurations: the reference's ``ModelConfig`` and ``PRESETS``,
re-exported (the module is pure Python and imports no jax)."""

from ggml_cuda_experiments_tpu.models.config import ModelConfig, PRESETS

__all__ = ["ModelConfig", "PRESETS"]
