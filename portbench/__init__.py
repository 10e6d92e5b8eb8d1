"""The benchmark of `encodec_tpu_torch` on one NVIDIA H100: `run.py` runs
one cell once (see `README.md`)."""
