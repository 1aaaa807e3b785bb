"""Output sinks: the run manifest and a JSONL metrics stream.

The manifest is the provenance block stamped into what a run emits — a
trace export (``trace.json``'s ``otherData.manifest``) and the header of
the JSONL metrics stream — so an artifact can be matched to the code,
framework and device that made it.  It records torch, CUDA and device
fields (``MANIFEST_KEYS``), where the reference records its JAX fields.
"""
from __future__ import annotations

import json
import platform
import subprocess
import sys
import time

import torch

MANIFEST_KEYS = (
    "git_sha",
    "torch_version",
    "cuda_version",
    "backend",
    "device_kind",
    "device_count",
    "python",
    "platform",
    "timestamp",
)


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_manifest() -> dict:
    """Provenance of the current run: the card when CUDA is available,
    else the CPU."""
    cuda = torch.cuda.is_available()
    return {
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "none",
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else platform.processor() or "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }


class JsonlSink:
    """Append-one-JSON-object-per-line stream.  First line is the run
    manifest; ``metrics()`` lines carry periodic registry snapshots and
    ``summary()`` closes the run."""

    def __init__(self, path):
        self.path = path
        self._wrote_header = False

    def _write(self, obj: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(obj) + "\n")

    def header(self, manifest: dict | None = None) -> None:
        self._write({"kind": "manifest", **(manifest or run_manifest())})
        self._wrote_header = True

    def metrics(self, snapshot: dict, step: int | None = None) -> None:
        if not self._wrote_header:
            self.header()
        rec = {"kind": "metrics"}
        if step is not None:
            rec["step"] = step
        rec.update(snapshot)
        self._write(rec)

    def summary(self, snapshot: dict, **extra) -> None:
        if not self._wrote_header:
            self.header()
        self._write({"kind": "summary", **extra, **snapshot})
