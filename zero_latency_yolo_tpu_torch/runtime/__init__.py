from .engine import EngineResult, InferenceEngine, InferenceRequest

__all__ = ["EngineResult", "InferenceEngine", "InferenceRequest"]
