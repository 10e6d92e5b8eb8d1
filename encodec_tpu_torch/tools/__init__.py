"""User tools: code extraction for dataset token dumps."""

from .inference import extract_codes  # noqa: F401
