from .cqt import CqtPlan, cqt
from .hcqt import compute_hopsize_cqt, efficient_hcqt_device, hcqt
