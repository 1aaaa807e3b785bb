"""The analytic roofline: a step's FLOPs, HBM bytes and collective bytes
per cell, and their seconds at the H100's peaks (``HW``)."""
from .analytic import HW, analyze_cell, collective_model, flops_model, hbm_model

__all__ = ["HW", "analyze_cell", "collective_model", "flops_model", "hbm_model"]
