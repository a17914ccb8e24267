"""Observability without dependencies: the span tracer (``obs.trace``)
and the registry-scoped metrics (``obs.metrics``) that the executors
report to. Chrome/Perfetto export waits for the session's tracer."""
