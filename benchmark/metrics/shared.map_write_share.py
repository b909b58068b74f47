"""The share of a shared-map fleet's ticks that wrote the shared map:
100 x ``fleet.map_writes`` (the ticks whose any-gate, the OR of the R
gates ``FleetSession``'s read brought back, was set) over the ticks
(``fleet.step``'s calls), warm-up included."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the counters
        return None
    c = tracing.counters()
    ticks = c.get("fleet.step", 0)
    if "fleet.map_writes" not in c or not ticks:
        return None
    return 100.0 * c["fleet.map_writes"] / ticks
