import contextlib

import torch


@contextlib.contextmanager
def float32_precision():
    """Run cuDNN convolutions and cuBLAS matmuls in full float32 (TF32 off)
    inside the block, restoring the caller's settings after.  cuDNN's
    default is TF32, which keeps about three decimal digits."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
