"""Typed errors shared by the lowering and the serving session."""
