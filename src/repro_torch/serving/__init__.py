from .engine import GenerationEngine, SamplerConfig

__all__ = ["GenerationEngine", "SamplerConfig"]
