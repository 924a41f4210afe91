from .env import env_flag, env_float, env_int
from .logging import get_logger
from .profiler import Profiler, profile_scope

__all__ = [
    "env_flag",
    "env_float",
    "env_int",
    "get_logger",
    "Profiler",
    "profile_scope",
]
