"""Telemetry for the port: the metrics registry and the host-side tracer
(copies of the reference package's pure-Python modules) and the run
manifest, which records torch, CUDA and device fields."""
from repro_torch.obs import trace
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
