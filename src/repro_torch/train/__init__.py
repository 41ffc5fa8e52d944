"""Training of the port: the train step (loss, backward, AdamW) and the
fault-tolerant trainer (the reference's ``repro.train``)."""
