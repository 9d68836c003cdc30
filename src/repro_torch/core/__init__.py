"""Phases, dataflow, ordering, convs and the execution planner."""
