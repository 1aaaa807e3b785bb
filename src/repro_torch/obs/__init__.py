"""Telemetry for the port: the metrics registry, the host-side tracer and
the structured logger (copies of the reference package's pure-Python
modules) and the run manifest, which records torch, CUDA and device
fields."""
from repro_torch.obs import trace
from repro_torch.obs.log import get_logger
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    reset_default,
)
from repro_torch.obs.sinks import run_manifest
from repro_torch.obs.trace import Tracer, disable as disable_tracing, enable as enable_tracing

__all__ = [
    "trace",
    "get_logger",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "reset_default",
    "run_manifest",
    "Tracer",
    "enable_tracing",
    "disable_tracing",
]


def configure(trace_path=None, capacity: int = 1 << 16):
    """Switch used by launch entry points: enable tracing when a ``--trace
    PATH`` was given, returning (tracer, path) — the tracer is the disabled
    singleton when path is None."""
    if trace_path is None:
        return trace.get(), None
    return trace.enable(capacity=capacity), trace_path
