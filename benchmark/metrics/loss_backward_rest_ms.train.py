"""The loss and the rest of the backward (``train.l1_dssim_loss``'s L1
and SSIM, autograd, the gather's transpose in ``ops/cuda/segment_sum.py``,
projection's backward): on the first checked step's inputs, the device
milliseconds (profiler) of the loss on the frame, forward and backward,
and of the backward from the frame to the leaves, less the training
compositor's kernels; mean."""

from benchmark import core


def read(rec: core.Record):
    return core.mean(rec.device_ms.get("loss_backward_rest", []))
