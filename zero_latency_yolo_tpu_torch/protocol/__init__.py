from .packets import Detection

__all__ = ["Detection"]
