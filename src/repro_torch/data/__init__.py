from .synthetic import DataConfig, PrefetchingLoader, SyntheticLM, to_device

__all__ = ["DataConfig", "PrefetchingLoader", "SyntheticLM", "to_device"]
