"""Chunked run executor of the port (the step loop of every sampling run),
with swept runs over a leading axis of seeds or hyperparameters."""
from .executor import (ChainExecutor, ChunkSnapshot, RunResult, ess_feedback_adapter, rollout,
                       stack_runs)

__all__ = ["ChainExecutor", "ChunkSnapshot", "RunResult", "ess_feedback_adapter", "rollout",
           "stack_runs"]
