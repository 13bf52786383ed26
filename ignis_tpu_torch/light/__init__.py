from ignis_tpu_torch.light.union import (  # noqa: F401
    env_emission_and_pdf, light_pdf_direct_solid, light_select_pdf,
    sample_light_direct, select_light, select_light_uniform,
)
