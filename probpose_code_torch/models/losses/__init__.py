from .classification_loss import BCELoss, KLDiscretLoss  # noqa: F401
from .heatmap_loss import AdaptiveWingLoss, KeypointMSELoss, OKSHeatmapLoss  # noqa: F401
from .regression_loss import L1LogLoss, MSELoss, SmoothL1Loss, SoftWingLoss, WingLoss  # noqa: F401
