"""The median of the benchmark's own span around each ``query`` call of
the window, on the host's clock, ended by the fetch of its top-k."""

import statistics


def read(run):
    calls = run.work.get("call_s")
    if not calls:
        return None
    return 1e3 * statistics.median(calls)
