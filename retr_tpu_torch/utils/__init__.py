"""Observability: structured logging and profiling (retr_tpu/utils)."""
