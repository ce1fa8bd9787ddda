"""Entry points of the port beside training (counterparts of ``scripts/``):
``python -m slcl_torch.scripts.gen_class_centers``,
``python -m slcl_torch.scripts.evaluate`` and
``python -m slcl_torch.scripts.stylize_samples``."""
