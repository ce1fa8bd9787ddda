"""Data parallelism and FSDP over processes (counterpart of
``slcl_tpu/parallel``): :mod:`.mesh`, and the gloo dry run
(``python -m slcl_torch.parallel.dryrun N``)."""
