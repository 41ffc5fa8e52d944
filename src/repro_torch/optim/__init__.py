"""Optimiser of the port: AdamW with global-norm clipping, the learning-rate
schedule, and int8 gradient compression (the reference's ``repro.optim``)."""
