"""Utilities: heatmap rendering, token cleanup, faithfulness."""

from lxt_tpu_torch.utils.faithfulness import (aopc_scores, auc,
                                              faithfulness_report,
                                              perturbation_curve)
from lxt_tpu_torch.utils.viz import (clean_tokens, html_heatmap,
                                     html_response_heatmap, pdf_heatmap)

__all__ = ["clean_tokens", "html_heatmap", "html_response_heatmap",
           "pdf_heatmap", "perturbation_curve", "aopc_scores", "auc",
           "faithfulness_report"]
