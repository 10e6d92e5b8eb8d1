"""User tools: token extraction over datasets and codebook diagnostics."""

from .inference import (  # noqa: F401
    code_distribution,
    decode_most_frequent,
    extract_codes,
    process_dataset,
)
