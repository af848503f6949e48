from .config import ModelConfig
from .initial import build_model
from .step import Step, build_multi_step, build_step

__all__ = ["ModelConfig", "Step", "build_model", "build_multi_step", "build_step"]
