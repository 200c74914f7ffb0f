"""The top-down transforms: LoadImage, GetBBoxCenterScale, the train
augmentations (RandomFlip, RandomHalfBody, RandomBBoxTransform),
TopdownAffine (canvas form), GenerateTarget (device-deferred form) and
PackPoseInputs."""

from .common import GenerateTarget, GetBBoxCenterScale, RandomBBoxTransform, RandomFlip, RandomHalfBody  # noqa: F401
from .formatting import PackPoseInputs  # noqa: F401
from .loading import LoadImage  # noqa: F401
from .topdown import TopdownAffine  # noqa: F401
