"""User tools: token extraction over datasets and codebook diagnostics
(`inference`), and the modules run with `python -m`: `export` (a run
directory to a reference `.th`), `batch` (directories of files),
`benchmark` (stage times) and `visualize` (figures, hierarchy ablation)."""

from .inference import (  # noqa: F401
    code_distribution,
    decode_most_frequent,
    extract_codes,
    process_dataset,
)
