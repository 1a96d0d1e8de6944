"""Ops of the port; CUDA kernels live in ``csrc/`` and build at first use."""

__all__ = ["kernel_launches"]


def kernel_launches() -> dict:
    """Every kernel of the port's launched by this process so far, by
    name: the LRN forward and backward entry points, nvJPEG's
    ``ycc_to_rgb`` and the NMS sweep."""
    from deepvision_tpu_torch.data.jpeg import ycc_launches
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    return {**local_response_norm_cuda.launches_by_kernel,
            **local_response_norm_backward_cuda.launches_by_kernel,
            "ycc_to_rgb": ycc_launches(),
            "nms_sweep": nms_sweep_cuda.launches}
