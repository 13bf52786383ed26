"""ignis_tpu_torch: the PyTorch/CUDA port of the ignis_tpu path tracer.

Laid out like the JAX package `ignis_tpu` so a reader finds the counterpart
of a module under the same name.  The package imports `torch` and `numpy`
only.  Entry points take an explicit `device` and default to the CUDA
device; they run on the CPU only when the caller passes `device="cpu"`.

    from ignis_tpu_torch.api import Runtime
    rt = Runtime(scene_dict_or_path, width=512, height=512)
    rt.step(spi=4)
    img = rt.currentFrame()
"""

import torch

# The path has no large matrix product, but its 3x3 / 3x4 einsums must stay
# full float32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
