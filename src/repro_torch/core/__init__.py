"""Streaming execution under an on-chip buffer budget: graph IR,
decomposition planner, static schedules and the graph executor."""
