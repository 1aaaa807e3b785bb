"""Telemetry for the port: the metrics registry, the host-side tracer and
the structured logger (copies of the reference package's pure-Python
modules), the run manifest, which records torch, CUDA and device fields,
the JSONL metrics sink, and the trace and manifest validator
(``python -m repro_torch.obs trace.json --require serve``)."""
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
from repro_torch.obs.sinks import JsonlSink, run_manifest
from repro_torch.obs.trace import Tracer, disable as disable_tracing, enable as enable_tracing
from repro_torch.obs.validate import validate_manifest, validate_trace

__all__ = [
    "trace",
    "get_logger",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "reset_default",
    "JsonlSink",
    "run_manifest",
    "Tracer",
    "enable_tracing",
    "disable_tracing",
    "validate_manifest",
    "validate_trace",
]


def configure(trace_path=None, capacity: int = 1 << 16):
    """Switch used by launch entry points: enable tracing when a ``--trace
    PATH`` was given, returning (tracer, path) — the tracer is the disabled
    singleton when path is None."""
    if trace_path is None:
        return trace.get(), None
    return trace.enable(capacity=capacity), trace_path
