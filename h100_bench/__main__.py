"""``python3 -m h100_bench``: one run of one cell (``run.py``)."""

import time

_T0 = time.time()

import sys  # noqa: E402

from h100_bench.run import main  # noqa: E402

sys.exit(main(t0=_T0))
