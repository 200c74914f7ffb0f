"""The loss wrapper of the integral regression configs in PyTorch.

Port of ``probpose_code_tpu/models/losses/loss_wrappers.py:MultipleLossWrapper``
(``:18-30``): one loss a member of a list of outputs, each applied to its
(input, target) pair with the keypoint weights. The integral configs build it
(``SmoothL1Loss`` with ``KeypointMSELoss`` or ``JSDiscretLoss``); no training
path of the port calls it (``models/builder.py:UNTRAINED_HEADS``).
"""

from __future__ import annotations

from typing import List

from probpose_code_torch.registry import MODELS


@MODELS.register_module()
class MultipleLossWrapper:
    def __init__(self, losses: List[dict]):
        self.num_losses = len(losses)
        self.loss_modules = [MODELS.build(dict(cfg)) for cfg in losses]

    def __call__(self, input_list, target_list, keypoint_weights=None):
        if not isinstance(input_list, (list, tuple)) or not isinstance(target_list, (list, tuple)) \
                or len(input_list) != len(target_list):
            raise ValueError("MultipleLossWrapper: takes lists of inputs and targets of one length")
        return [loss(inp, tgt, keypoint_weights)
                for loss, inp, tgt in zip(self.loss_modules, input_list, target_list)]
