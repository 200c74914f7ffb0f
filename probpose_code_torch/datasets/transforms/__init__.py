"""The top-down val transforms: LoadImage, GetBBoxCenterScale, TopdownAffine
(canvas form) and PackPoseInputs."""

from .common import GetBBoxCenterScale  # noqa: F401
from .formatting import PackPoseInputs  # noqa: F401
from .loading import LoadImage  # noqa: F401
from .topdown import TopdownAffine  # noqa: F401
