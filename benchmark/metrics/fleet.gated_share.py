"""The share of the fleet's robot-scans whose gate fired: 100 x
``fleet.gated`` (the robots whose gate ``FleetSession``'s read brought
back set) over ``fleet.robot_steps`` (R a tick), warm-up included."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the counters
        return None
    c = tracing.counters()
    steps = c.get("fleet.robot_steps", 0)
    return 100.0 * c.get("fleet.gated", 0) / steps if steps else None
