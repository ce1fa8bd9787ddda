"""Evaluation of the port (counterpart of ``slcl_tpu/eval``)."""
from .evaluator import Evaluator, evaluate_arrays, mean_fg_dice  # noqa: F401
