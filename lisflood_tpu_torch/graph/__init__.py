from .ldd import FlowGraph, RoutingSchedule, build_schedule, direction_codes

__all__ = ["FlowGraph", "RoutingSchedule", "build_schedule", "direction_codes"]
