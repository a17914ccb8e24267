"""Typed error taxonomy for the graceful-degradation runtime.

Every stage of the executor pipeline gets its own exception class, so
the fallback chain (runtime/fallback.py) can tell *where* a node died
and the degradation event can carry a machine-readable cause:

  * ``PlanError``        — the decomposition planner could not produce
                           a feasible schedule (``plan_for_vmem``,
                           ``compile_layer`` plan/layer mismatches).
  * ``LoweringError``    — a schedule lowered to an invalid program
                           (``validate_waves`` / ``validate_kernel_program``
                           / ``validate_graph_kernel`` / ``plan_arena``
                           and the lowering entry points themselves).
  * ``BudgetExceeded``   — the lowered program's working set does not
                           fit the VMEM budget it must run under.
  * ``KernelLaunchError``— the kernel failed at trace/launch time
                           (Pallas lowering, operand-table upload).
  * ``NumericGuardTripped`` — a post-execution guard (runtime/guard.py)
                           rejected the output (NaN/Inf, int8
                           saturation) and the reference path took over.

All of these subclass ``ExecutorError`` which subclasses ``ValueError``
— pre-existing callers (and tests) catching ``ValueError`` at the
validation sites keep working unchanged.

The serving-boundary errors (``Overloaded``, ``DeadlineExceeded``,
``RestartsExhausted``) are ``RuntimeError`` subclasses: they describe
load conditions, not broken programs, and must NOT be swallowed by
``except ValueError`` input-validation handlers.

This module imports nothing from the rest of the package, so
``core/schedule.py`` and the kernels can raise the taxonomy without
import cycles.
"""
from __future__ import annotations


class ExecutorError(ValueError):
    """Base for every executor-pipeline failure the runtime can degrade
    past. Subclasses ``ValueError`` for backward compatibility with the
    pre-taxonomy validation sites."""


class PlanError(ExecutorError):
    """The planner produced no feasible decomposition for this node."""


class LoweringError(ExecutorError):
    """The schedule lowered to a program that failed validation."""


class BudgetExceeded(ExecutorError):
    """The lowered program's working set exceeds its VMEM budget."""


class KernelLaunchError(ExecutorError):
    """The kernel failed at trace/launch time."""


class NumericGuardTripped(ExecutorError):
    """A post-execution numeric guard rejected the output."""


class FallbackExhausted(ExecutorError):
    """A node failed at every mode in its fallback chain."""


class Overloaded(RuntimeError):
    """The session's bounded pending queue is full — request shed."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline expired before its batch ran."""


class RestartsExhausted(RuntimeError):
    """``run_with_restarts`` gave up after ``max_restarts`` failures."""
