"""Chunked run executor of the port (the step loop of every sampling run)."""
from .executor import ChainExecutor, ChunkSnapshot, RunResult, ess_feedback_adapter, rollout

__all__ = ["ChainExecutor", "ChunkSnapshot", "RunResult", "ess_feedback_adapter", "rollout"]
