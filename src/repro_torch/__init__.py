"""PyTorch/CUDA port of the streaming CNN accelerator (``repro``).

Mirrors ``src/repro``'s layout: ``core`` (graph, planner, schedules,
executors), ``kernels`` (hand-written CUDA kernels with their plain
PyTorch versions), ``models``, ``launch`` (serving). Imports ``torch`` and
numpy, never JAX and nothing of the ``repro`` package.
"""
