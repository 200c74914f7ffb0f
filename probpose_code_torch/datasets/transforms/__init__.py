"""The top-down transforms: LoadImage, GetBBoxCenterScale, the train
augmentations (RandomFlip, RandomHalfBody, RandomBBoxTransform), TopdownAffine
(canvas form), the photometric augmentations' worker halves
(YOLOXHSVRandomAug, Albumentation), GenerateTarget (device-deferred form),
KeypointConverter and PackPoseInputs."""

from .common import (  # noqa: F401
    Albumentation,
    GenerateTarget,
    GetBBoxCenterScale,
    RandomBBoxTransform,
    RandomFlip,
    RandomHalfBody,
    YOLOXHSVRandomAug,
)
from .converting import KeypointConverter  # noqa: F401
from .formatting import PackPoseInputs  # noqa: F401
from .loading import LoadImage  # noqa: F401
from .topdown import TopdownAffine  # noqa: F401
