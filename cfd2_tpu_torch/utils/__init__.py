"""Shared utilities: structured metrics logging and run summaries."""

from .metrics import MetricsLog

__all__ = ["MetricsLog"]
