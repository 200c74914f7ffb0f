from .classification_loss import BCELoss, KLDiscretLoss  # noqa: F401
from .heatmap_loss import KeypointMSELoss, OKSHeatmapLoss  # noqa: F401
from .regression_loss import L1LogLoss, MSELoss  # noqa: F401
