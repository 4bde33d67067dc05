from repro_torch.configs.base import RetrieverConfig
from repro_torch.configs.registry import PAPER_ARCHS, get_config

__all__ = ["RetrieverConfig", "PAPER_ARCHS", "get_config"]
