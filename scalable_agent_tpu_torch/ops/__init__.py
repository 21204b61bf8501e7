import contextlib

import torch


@contextlib.contextmanager
def float32_precision():
    """Sum every product in float32 inside the block, as JAX's
    ``preferred_element_type=float32`` does, restoring the caller's
    settings after: cuDNN convolutions and cuBLAS matmuls of float32 run
    in full float32 (TF32 off; cuDNN's default TF32 keeps about three
    decimal digits), and cuBLAS may not reduce bf16 products in bf16."""
    matmul = torch.backends.cuda.matmul
    saved = (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved
