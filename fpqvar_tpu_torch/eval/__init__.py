"""Evaluation: Inception features, FID / sFID / IS / precision-recall,
PNG I/O and the eval-set generator."""
from fpqvar_tpu_torch.eval import imaging, metrics  # noqa: F401
