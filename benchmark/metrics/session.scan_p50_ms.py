"""The session's own time per scan, median over the window's scans:
``SlamSession``'s timing stats (the host clock from a scan's entry into
``process_scan`` to its pose on the host), which leave out the open
loop's wait for the scan's due time."""

import numpy as np


def read(run):
    ms = run.info.get("session_scan_ms")
    return float(np.percentile(ms, 50)) if ms else None
