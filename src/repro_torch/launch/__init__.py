"""``repro_torch.launch`` — the production meshes as specs, the dry-run's
cell specs, the step-cost counter and the dry-run itself (counterpart of
``repro/launch``)."""
