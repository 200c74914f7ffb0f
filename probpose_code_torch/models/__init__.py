"""Models: ViT backbone, ProbMapHead, the top-down estimator and the builder."""

from .builder import PoseModel, build_pose_estimator  # noqa: F401
