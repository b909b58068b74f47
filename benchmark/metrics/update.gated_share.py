"""The share of map update bodies whose gate fired: 100 x the session's
scans with a gated update (``update.gated``) over the update bodies run
(``update.runs``: on the compiled step one a scan, and one in its graph's
warm-up)."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the counters
        return None
    c = tracing.counters()
    runs = c.get("update.runs", 0)
    return 100.0 * c.get("update.gated", 0) / runs if runs else None
