"""The share of a shared-map fleet's robot-scans whose gate fired, read
as ``fleet.gated_share`` reads a fleet's: 100 x ``fleet.gated`` over
``fleet.robot_steps``, warm-up included. The gated robots are those whose
beams a tick's paint stores; ``shared.map_write_share`` counts the ticks
where any robot gated."""

from benchmark.harness.spec import metric_reader


def read(run):
    return metric_reader("fleet.gated_share").read(run)
