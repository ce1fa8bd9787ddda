"""Entry points of the port beside training (counterparts of ``scripts/``):
``python -m slcl_torch.scripts.gen_class_centers`` and
``python -m slcl_torch.scripts.evaluate``."""
