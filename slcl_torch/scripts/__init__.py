"""Entry points of the port beside training (counterparts of ``scripts/``):
``python -m slcl_torch.scripts.gen_class_centers``,
``python -m slcl_torch.scripts.evaluate``,
``python -m slcl_torch.scripts.stylize_samples``,
``python -m slcl_torch.scripts.export`` and
``python -m slcl_torch.scripts.predict``."""
