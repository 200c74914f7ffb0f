from .classification_loss import BCELoss, JSDiscretLoss, KLDiscretLoss  # noqa: F401
from .heatmap_loss import AdaptiveWingLoss, KeypointMSELoss, OKSHeatmapLoss  # noqa: F401
from .regression_loss import L1LogLoss, MSELoss, RLELoss, SmoothL1Loss, SoftWingLoss, WingLoss  # noqa: F401
from .loss_wrappers import MultipleLossWrapper  # noqa: F401
