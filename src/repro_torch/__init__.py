"""PyTorch/CUDA port of the FIGLUT reproduction.

A second package beside ``repro`` (the JAX reference).  It keeps the
reference's module layout so every module sits opposite its
counterpart: ``core`` (plane layout, BCQ, host LUT math, mixed-precision
allocation, linear execution), ``quant`` (spec, BCQ/RTN/ternary
formats, backends, bit plans, ``quantize_model``, quantized
checkpoints), ``kernels`` (hand-written CUDA kernels for Hopper, each
beside its plain PyTorch version), ``configs``, ``models``, ``serve``,
``obs`` (serving traces), ``data`` (token pipelines), ``optim``
(AdamW), ``train`` (the trainer and the numpy checkpoint layout) and
``launch``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain version, because CUDA
has no interpret mode.
"""

__all__ = ["default_device"]


def default_device(device=None):
    """Resolve a device argument: ``None`` means the card."""
    import torch
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
