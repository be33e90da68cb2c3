"""Training, evaluation and metrics of the port (counterpart of
``papc_tpu.train``)."""

from papc_tpu_torch.train.evaluate import eval_step, evaluate
from papc_tpu_torch.train.metrics import accuracy, softmax_cross_entropy
from papc_tpu_torch.train.trainer import make_optimizer, train, train_step

__all__ = ["accuracy", "eval_step", "evaluate", "make_optimizer",
           "softmax_cross_entropy", "train", "train_step"]
