"""Utilities of the port (configuration)."""

from .config import Config, Parameter, config
