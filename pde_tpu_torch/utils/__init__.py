"""Utilities of the port (configuration, online statistics)."""

from .config import Config, Parameter, config, environment
from .math import OnlineStatistics
