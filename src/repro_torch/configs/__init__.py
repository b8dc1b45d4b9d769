from .base import SHAPES, ModelConfig, MoEConfig, ShapeConfig, SSMConfig
from .registry import ARCHS, get_config, list_archs, smoke_config
