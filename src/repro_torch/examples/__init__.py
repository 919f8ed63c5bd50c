"""The reference's entry points (``examples/*.py``) on the port's API.

One module per script, named as the script and run as ``python -m
repro_torch.examples.<name>``: ``quickstart``, ``serve_ann``,
``build_spot_index``, ``lm_embed_index``, ``train_lm`` and ``serve_lm``.
Each takes the script's arguments and defaults and one more,
``--device`` (``cuda`` by default, resolved by
:func:`repro_torch.device.resolve_device`: without a card it raises unless
``--device cpu`` is given), prints the script's lines with the port's
backend names (``jax`` → ``torch``, ``pallas`` → ``fused``), and exposes
``main(argv=None) -> int`` so a caller can run it in process.
"""
