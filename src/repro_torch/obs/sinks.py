"""The run manifest: the provenance block stamped into a trace export
(``trace.json``'s ``otherData.manifest``), so an artifact can be matched
to the code, framework and device that made it.  It records torch, CUDA
and device fields."""
from __future__ import annotations

import platform
import subprocess
import sys
import time

import torch

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
