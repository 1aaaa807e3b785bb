"""Training stack of the port: the grad and step constructors, and the loop."""
from .loop import LoopConfig, Preempted, run
from .step import make_grad_fn, make_train_step

__all__ = ["LoopConfig", "Preempted", "make_grad_fn", "make_train_step", "run"]
