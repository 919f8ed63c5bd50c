"""Shared building blocks of the port (counterpart of ``repro/common``)."""
