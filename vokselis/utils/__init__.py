"""Utilities: grid math, logging helpers, multimap (SURVEY.md H15)."""

from vokselis.utils.grid import dispatch_optimal, cdiv, round_up
from vokselis.utils.misc import (
    ContinuousDict,
    ImageDimensions,
    create_folder,
    green_blink,
)

__all__ = [
    "dispatch_optimal",
    "cdiv",
    "round_up",
    "ContinuousDict",
    "ImageDimensions",
    "create_folder",
    "green_blink",
]
