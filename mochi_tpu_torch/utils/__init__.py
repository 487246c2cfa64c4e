from .metrics import Metrics, Timer

__all__ = ["Metrics", "Timer"]
