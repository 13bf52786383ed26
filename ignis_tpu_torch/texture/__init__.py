from ignis_tpu_torch.texture.eval import eval_texture_stack, resolve_color  # noqa: F401
