from .engine import GenerationResult, InferenceEngine

__all__ = ["InferenceEngine", "GenerationResult"]
