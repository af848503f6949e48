from .config import ModelConfig
from .step import Step, build_multi_step, build_step

__all__ = ["ModelConfig", "Step", "build_multi_step", "build_step"]
