from .engine import GenerationResult, ServingEngine

__all__ = ["ServingEngine", "GenerationResult"]
