"""PyTorch/CUDA port of the ``repro`` diverse k-NN search system.

Module layout mirrors ``repro``: ``repro.X.Y`` and ``repro_torch.X.Y`` hold
the same functions, so the two can be compared file by file. This package
imports ``torch``, numpy and the standard library only — never ``jax`` or
``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On a
CUDA tensor the kernel wrappers launch the hand-written kernels under
``kernels/csrc`` (built with ``nvcc`` at first use); on a CPU tensor they use
the plain PyTorch version in ``kernels/ref.py``.
"""
import torch

# A TF32 Gram flips ``sim > eps`` edges; every float32 product stays IEEE.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# cuBLAS may otherwise reduce a bf16 product's split-K partial sums in bf16;
# the decoder's matmuls (models.layers.dot_f32) keep the reference's float32
# accumulation and round once.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise."""
    return torch.device(DEFAULT_DEVICE if device is None else device)
