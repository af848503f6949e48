from .ldd import (FlowGraph, RoutingSchedule, build_flow_graph, build_schedule,
                  cut_structures, direction_codes, ldd_mask, ldd_to_channel, window_total)

__all__ = ["FlowGraph", "RoutingSchedule", "build_flow_graph", "build_schedule",
           "cut_structures", "direction_codes", "ldd_mask", "ldd_to_channel", "window_total"]
