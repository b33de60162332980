from .metrics import (RollingMetricBuffer, compute_ranking_metrics, log_loss,
                      roc_auc_score)

__all__ = ["RollingMetricBuffer", "compute_ranking_metrics", "log_loss",
           "roc_auc_score"]
