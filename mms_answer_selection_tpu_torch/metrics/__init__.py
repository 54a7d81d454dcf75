from .ir_metrics import (  # noqa: F401
    auc,
    auc_torch,
    auc_torch_sorted,
    mean_average_precision,
    mean_average_precision_torch,
    mean_average_precision_torch_sorted,
    mean_reciprocal_rank,
    mean_reciprocal_rank_torch,
    mean_reciprocal_rank_torch_sorted,
    rank_accuracy,
    rank_accuracy_torch,
)
from .trec_eval import (  # noqa: F401
    filter_effective_groups,
    format_trec_table,
    trec_eval,
    write_trec_files,
)
