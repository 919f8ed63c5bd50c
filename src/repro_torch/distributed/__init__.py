"""``repro_torch.distributed`` — logical-axis sharding rules (counterpart
of ``repro/distributed``), resolved against mesh specs on one card."""
