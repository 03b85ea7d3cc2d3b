"""Hamming-ranking evaluation: the numpy oracle, exact device MAP@R and
P@H<=r, and the histogram (streaming) metrics."""

from hashgan_tpu_torch.eval.oracle import (  # noqa: F401
    average_precision_np,
    mean_average_precision_np,
    precision_at_radius_np,
    precision_recall_curve_np,
)
from hashgan_tpu_torch.eval.map import (  # noqa: F401
    device_map_at_r,
    device_precision_at_radius,
)
from hashgan_tpu_torch.eval.streaming import (  # noqa: F401
    device_distance_histograms,
    pr_curve_from_hist,
    precision_at_radius_from_hist,
    precision_at_topn_from_hist,
    tie_aware_map,
)
