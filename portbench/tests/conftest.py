"""The benchmark's tests: the checkout's root on the path, so that
`portbench` and `encodec_tpu_torch` import as the run does."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
