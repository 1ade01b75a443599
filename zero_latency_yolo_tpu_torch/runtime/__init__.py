from .tracker import KalmanTracker, MultiObjectTracker  # noqa: F401
from .engine import EngineResult, InferenceEngine, InferenceRequest  # noqa: F401
from .adapters import GameAdapter, get_adapter  # noqa: F401
