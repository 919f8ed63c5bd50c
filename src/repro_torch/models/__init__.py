"""Language models of the port (counterpart of ``repro/models``): the dense
family's prefill and decode, on the card through K5 and K6."""
