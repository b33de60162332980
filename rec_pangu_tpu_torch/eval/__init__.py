from .metrics import (RollingMetricBuffer, compute_ranking_metrics, log_loss,
                      roc_auc_score)
from .retrieval import (batched_merge_multi_interest_np, evaluate_recall,
                        get_recall_predict, l2_normalize, make_topn_scorer,
                        merge_multi_interest)

__all__ = ["RollingMetricBuffer", "compute_ranking_metrics", "log_loss",
           "roc_auc_score", "batched_merge_multi_interest_np", "evaluate_recall",
           "get_recall_predict", "l2_normalize", "make_topn_scorer",
           "merge_multi_interest"]
