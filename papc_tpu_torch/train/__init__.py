"""Evaluation and metrics of the port (counterpart of ``papc_tpu.train``).
Training is not ported yet (``ROADMAP.md``, Queue 1)."""

from papc_tpu_torch.train.evaluate import eval_step, evaluate
from papc_tpu_torch.train.metrics import accuracy, softmax_cross_entropy

__all__ = ["accuracy", "eval_step", "evaluate", "softmax_cross_entropy"]
