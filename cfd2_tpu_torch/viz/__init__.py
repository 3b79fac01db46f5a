"""Headless visualization of solver fields."""

from .html_viewer import write_html_viewer
from .renderer import FieldRenderer, rainbow_colormap

__all__ = ["FieldRenderer", "rainbow_colormap", "write_html_viewer"]
