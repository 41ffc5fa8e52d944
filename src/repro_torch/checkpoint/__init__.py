"""Atomic, manifest-verified checkpoints (the reference's
``repro.checkpoint``, same on-disk layout)."""
