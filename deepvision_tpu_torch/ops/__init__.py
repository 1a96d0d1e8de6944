"""Ops of the port; CUDA kernels live in ``csrc/`` and build at first use."""

import threading

__all__ = ["kernel_launches", "credit_launches", "captured_launches",
           "note_captured"]

_captured = threading.local()  # this thread's kernel calls into captures


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


def note_captured(name: str) -> None:
    """A wrapper's call of kernel ``name`` (named as
    :func:`kernel_launches` names it) while the current stream was being
    captured into a CUDA graph: the kernel was recorded into the graph,
    not launched, so the wrapper notes it here instead of counting a
    launch. Each replay of the graph launches it."""
    counts = _captured.__dict__.setdefault("counts", {})
    counts[name] = counts.get(name, 0) + 1


def captured_launches() -> dict:
    """The kernels that this thread's wrappers have recorded into CUDA
    graph captures so far, by name (:func:`note_captured`)."""
    return dict(getattr(_captured, "counts", {}))


def credit_launches(counts: dict) -> None:
    """Add ``counts`` (name -> launches, named as :func:`kernel_launches`
    names them) to the kernels' counters. A CUDA graph's replay launches
    the kernels that its capture recorded without calling their
    wrappers: ``serve/models.CudaGraphRunner`` credits them at each
    replay, so that the counts stay true launches."""
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    for name, n in counts.items():
        if n < 0:
            raise ValueError(f"a replay launches {name!r} {n} times")
        if name == "nms_sweep":
            nms_sweep_cuda.launches += n
            continue
        for wrapper in (local_response_norm_cuda,
                        local_response_norm_backward_cuda):
            if name in wrapper.launches_by_kernel:
                wrapper.launches_by_kernel[name] += n
                wrapper.launches += n
                break
        else:
            raise ValueError(f"no kernel {name!r} can run in a CUDA graph")
