from .logging import get_logger, init_logging  # noqa: F401
from .events import EventBus, EVENT_BUS  # noqa: F401
from .stats import RollingStats, Counter  # noqa: F401
