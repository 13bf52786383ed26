from ignis_tpu_torch.bsdf.layered import (  # noqa: F401
    bsdf_eval, bsdf_pdf, bsdf_sample, prepare_surface,
)
from ignis_tpu_torch.bsdf.union import bsdf_specular_mask  # noqa: F401
